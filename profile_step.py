"""Trace two llama2-1b train steps on the GPU and split the device time
into buckets (the ``--profile`` torch.profiler flow of the reference,
llm_pretrain.py:186-188, with the analysis inline).

Each kernel of the step's module is bucketed by what it computes:
library kernels by name (cuBLAS int8 / bf16 GEMMs, cuDNN attention) and
XLA fusions by their HLO instruction — GEMM fusions by operand type, the
rest by the named scope the model code sets (``quantize``, ``norm``,
``rope``, ``silu_mul``, ``attention``, ``loss``, ``optimizer``). For each
bucket: ms per step and, for the int8 mixed-precision step, the share of
the data-sheet roofline against the bucket's least work (``step_work``):
FLOPs for the int8 GEMMs and cuDNN attention, HBM bytes for the
memory-bound passes. The device's busy and idle share come from the
union of the step's kernel intervals.

Usage:
  python profile_step.py [--quantize mixed_precision] [--quantize_kwargs '{}']
                         [--bs 4] [--seq 2048] [--out runs/profile]
  python profile_step.py --analyze runs/profile   # re-read a trace
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import re
from collections import defaultdict
from pathlib import Path

N_STEPS = 2
SCOPES = ("attention", "quantize", "norm", "rope", "silu_mul", "loss", "optimizer")
FAMILY = "quantize+norm+rope+silu_mul"


def parse_hlo(hlo: str) -> dict[str, str]:
    """instruction name -> its line in the compiled HLO; kernels are named
    after their instruction with '.' and '-' as '_'."""
    out = {}
    for line in hlo.splitlines():
        m = re.match(r"\s*(?:ROOT )?%?([\w.\-]+) = (.*)", line)
        if m:
            out[m.group(1)] = m.group(2)
            out.setdefault(re.sub(r"[.\-]", "_", m.group(1)), m.group(2))
    return out


def classify(kernel: str, line: str, hlo: dict[str, str]) -> str:
    if re.search(r"sdpa|fmha|flash|cudnn", kernel):
        return "attention (cuDNN)"
    if re.search(r"i8i32|imma|_s8_", kernel):
        return "int8 GEMM"
    if re.search(r"nvjet|xmma_gemm|cutlass|gemm_bf16|sgemm", kernel):
        return "bf16/f32 GEMM"
    if "gemm_fusion" in kernel or "__triton_gemm" in line:
        first = re.findall(r"%([\w.\-]+)", line.partition("(")[2])[:2]
        int8 = any(hlo.get(o, "").startswith("s8[") for o in first)
        return "int8 GEMM" if int8 else "bf16/f32 GEMM"
    meta = re.search(r'op_name="([^"]*)"', line)
    op_name = meta.group(1) if meta else ""
    for scope in SCOPES:
        if f"/{scope}/" in op_name or op_name.endswith(f"/{scope}"):
            return scope
    return "other" if line else "unmatched"


def step_work(meta: dict) -> dict[str, tuple[str, float]]:
    """Least work of each bucket of the llama2-1b int8 mixed-precision
    step with remat (the forward runs twice): ("flops", n) for the int8
    GEMMs and cuDNN attention (bwd at 2.5x fwd), ("bytes", n) for the
    memory-bound passes — each tensor read and written once per pass:
    bf16 -> int8 quantize 3 B/element (both-axis 4 B), norm 4 B fwd / 6 B
    bwd, rope 4 B, silu*mul 6 B fwd / 10 B bwd, AdamW 22 B/param. XLA
    fuses norm, rope and silu*mul into the quantize passes in varying
    ways, so the four are one family (FAMILY)."""
    from quantized_training_tpu.models import llama

    c = llama.LLAMA2_1B
    B, S = meta["bs"], meta["seq"]
    T, L = B * S, c.num_hidden_layers
    hd, D, F = c.head_dim, c.hidden_size, c.intermediate_size
    Hh, KVh = c.num_attention_heads * hd, c.num_key_value_heads * hd
    w = D * (Hh + 2 * KVh) + D * Hh + 3 * D * F  # decoder linear weights
    acts = T * (2 * D + Hh + F)  # linear inputs (q/k/v and gate/up share one)
    out_grads = T * (Hh + 2 * KVh + D + 2 * F + D)
    quantize = 2 * 3 * (acts + w) + 4 * out_grads + 3 * (w + acts)
    n_params = L * (w + 2 * D) + 2 * c.vocab_size * D + D
    norm = L * 2 * T * D * (2 * 4 + 6) + T * D * (4 + 6)
    rope = L * 3 * 4 * T * (Hh + KVh)
    silu_mul = L * T * F * (2 * 6 + 10)
    return {
        "int8 GEMM": ("flops", 4 * 2 * T * w * L),
        "attention (cuDNN)": ("flops", 4.5 * L * 4 * B * c.num_attention_heads * S * S * hd / 2),
        FAMILY: ("bytes", L * quantize + norm + rope + silu_mul),
        "optimizer": ("bytes", 22 * n_params),
    }


def trace_step(args, out: Path) -> dict:
    """Compile, warm and trace two steps; writes the HLO and the trace
    under ``out`` and returns the run's metadata."""
    import jax
    import jax.numpy as jnp

    from quantized_training_tpu import optim, quant
    from quantized_training_tpu.models import llama
    from quantized_training_tpu.train import init_train_state, make_train_step
    from quantized_training_tpu.utils.runtime import (
        gpu_name_and_power_limit, require_gpu, setup_compile_cache,
    )

    info = require_gpu()
    setup_compile_cache()
    cfg = dataclasses.replace(llama.LLAMA2_1B, max_position_embeddings=args.seq, remat=True)
    params = llama.init_params(jax.random.PRNGKey(0), cfg)
    qparams = quant.quantize_params(params, args.quantize, **args.quantize_kwargs)
    optimizer = optim.adamw()
    state = init_train_state(qparams, optimizer)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (args.bs, args.seq), 0, cfg.vocab_size)
    labels = jnp.roll(tokens, -1, axis=-1)
    keys = jax.random.split(jax.random.PRNGKey(2), N_STEPS + 1)
    step_fn = make_train_step(cfg, optimizer).lower(state, tokens, labels, 1e-4, keys[0]).compile()
    (out / "step.hlo.txt").write_text(step_fn.as_text())
    state, m = step_fn(state, tokens, labels, 1e-4, keys[0])
    jax.block_until_ready(m)
    with jax.profiler.trace(str(out / "trace")):
        for i in range(N_STEPS):
            state, m = step_fn(state, tokens, labels, 1e-4, keys[i + 1])
        jax.block_until_ready(m)
    meta = dict(card=gpu_name_and_power_limit(), device=info, scheme=args.quantize,
                kwargs=args.quantize_kwargs, bs=args.bs, seq=args.seq)
    (out / "meta.json").write_text(json.dumps(meta))
    return meta


def analyze(out: Path, meta: dict) -> dict:
    import jax

    from quantized_training_tpu.utils.runtime import peaks

    pk = peaks(meta["device"]["kind"])
    hlo = parse_hlo((out / "step.hlo.txt").read_text())
    path = sorted(glob.glob(f"{out}/trace/**/*.xplane.pb", recursive=True))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    planes = [p for p in pd.planes if p.name.startswith("/device:GPU:0")]
    if not planes:
        raise SystemExit(f"no GPU plane in the trace: {[p.name for p in pd.planes]}")
    evs = []
    for line in planes[0].lines:
        for e in line.events:
            st = dict(e.stats)
            if str(st.get("hlo_module", "")).startswith("jit_train_step"):
                op = st.get("hlo_op")
                kernel = e.name if op in (None, "command_buffer") else op
                evs.append((e.start_ns, e.duration_ns, kernel))
    evs.sort()

    busy, end = 0, 0
    for start, dur, _ in evs:
        busy += max(0, start + dur - max(start, end))
        end = max(end, start + dur)
    window = end - evs[0][0]

    buckets = defaultdict(lambda: dict(ms=0.0, n=0))
    top = defaultdict(float)
    for _, dur, kernel in evs:
        line = hlo.get(kernel, "")
        bucket = classify(kernel, line, hlo)
        b = buckets[bucket]
        b["ms"] += dur / 1e6 / N_STEPS
        b["n"] += 1
        top[(bucket, kernel)] += dur / 1e6 / N_STEPS

    work = step_work(meta) if meta["scheme"] == "mixed_precision" and not meta["kwargs"] else {}
    busy_ms = busy / 1e6 / N_STEPS
    rows = []
    for bucket, b in sorted(buckets.items(), key=lambda kv: -kv[1]["ms"]):
        row = dict(bucket=bucket, ms_per_step=b["ms"], share_of_busy=b["ms"] / busy_ms,
                   kernels_per_step=b["n"] / N_STEPS)
        kind, n = work.get(bucket, (None, 0.0))
        if kind == "flops":
            peak = pk["int8_tops"] if bucket == "int8 GEMM" else pk["bf16_tflops"]
            row.update(least_tflop=n / 1e12, achieved_tflops=n / b["ms"] / 1e9,
                       roofline_share=n / (peak * 1e12) / (b["ms"] / 1e3))
        elif kind == "bytes":
            row.update(least_gbytes=n / 1e9, achieved_gbps=n / b["ms"] / 1e6,
                       roofline_share=n / (pk["hbm_tbps"] * 1e12) / (b["ms"] / 1e3))
        rows.append(row)
    family = [r for r in rows if r["bucket"] in FAMILY.split("+")]
    if FAMILY in work and family:
        ms = sum(r["ms_per_step"] for r in family)
        n = work[FAMILY][1]
        rows.append(dict(bucket=FAMILY, ms_per_step=ms, share_of_busy=ms / busy_ms,
                         least_gbytes=n / 1e9, achieved_gbps=n / ms / 1e6,
                         roofline_share=n / (pk["hbm_tbps"] * 1e12) / (ms / 1e3)))
    summary = dict(**meta, step_window_ms=window / 1e6 / N_STEPS, device_busy_ms=busy_ms,
                   idle_share=1 - busy / window, buckets=rows,
                   top_kernels=[dict(bucket=k[0], kernel=k[1], ms=v) for k, v in
                                sorted(top.items(), key=lambda kv: -kv[1])[:40]])
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    return summary


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quantize", default="mixed_precision")
    ap.add_argument("--quantize_kwargs", type=json.loads, default={})
    ap.add_argument("--bs", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--out", default="runs/profile")
    ap.add_argument("--analyze", help="directory of an earlier run to re-read")
    args = ap.parse_args()

    if args.analyze:
        out = Path(args.analyze)
        meta = json.loads((out / "meta.json").read_text())
    else:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        meta = trace_step(args, out)
    s = analyze(out, meta)
    print(meta)
    print(f"window {s['step_window_ms']:.2f} ms/step, busy {s['device_busy_ms']:.2f} ms, "
          f"idle share {s['idle_share']:.4f}")
    for r in s["buckets"]:
        print(json.dumps(r))
    for t in s["top_kernels"][:25]:
        print(json.dumps(t))


if __name__ == "__main__":
    main()
