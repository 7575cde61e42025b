#!/usr/bin/env python3
"""Smoke test of the system's main path on an NVIDIA GPU, at llama2-1b's
full width with random weights made from a seed.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --four     # four cards: the multi-card paths only

Phases (one result line each; a failing check makes the exit code 1, an
exception ends the run):

1. card: the card's name and power limit (nvidia-smi, in a child process).
2. gpu-tests: ``pytest -m gpu tests/`` in a child, before this process
   takes the card, so only one process holds it at a time.
3. train: ``llm_pretrain.main`` at seq 2048, batch 4, activation
   checkpointing, 4 steps, under each quantization scheme. Losses must be
   finite and the step-0 loss within 0.05 nats of bf16 (same init and
   batch; BitNet, with ternary weights, is exempt).
4. serve: int8 weights (``int8_quantized_training``). ``generate`` on 4 prompts
   of 512 tokens; then the continuous-batching server answers 16 requests
   (prompts 32-480 tokens, budgets 32-128, 8 slots), and batched
   ``generate`` answers the same prompts. The two programs sum in
   different orders (other batch shapes, attention windows, prefill
   lengths), and random weights leave the top logits close, so greedy
   streams part at near-ties: the count of equal streams is printed. The
   check is teacher-forced instead, for every stream of the server and of
   ``generate``: at every position, the chosen token's logit under the
   reference (one batched prefill of prompt + stream through the plain
   cache-einsum attention) must be within TIE_LOGITS of the top logit.
5. vit: one int8 mixed-precision step of ViT-Base, batch 64, 224 px,
   through ``vit_train.main``.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
With no GPU, or outside a checkout of the repository, the script exits
non-zero before printing it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

SEQ, BATCH, STEPS = 2048, 4, 4
LOSS_BAND = 0.05  # nats, step-0 loss against bf16
SCHEMES = {
    "bf16": (None, {}),
    "int8-mp": ("mixed_precision", {}),
    "int8-mp-sr": ("mixed_precision", {"stochastic_rounding": True}),
    "fp8-row": ("mixed_precision", {"dtype": "fp8_e4m3"}),
    "fp8-tile": ("mixed_precision", {"dtype": "fp8_e4m3", "scale": "tile"}),
    "int8-qt": ("int8_quantized_training", {}),
    "int4-wo": ("int4_weight_only", {}),
    "bitnet": ("bitnet", {}),
}
FOUR_LOSS_TOL = 1e-2  # nats, sharded against one card
# AdamW's first steps move every weight by about lr whatever its gradient,
# so rounding-level gradient differences become lr-sized weight
# differences; a lower lr than pretraining's 3e-4 keeps that noise well
# inside the tolerance while a sharding fault still shows
FOUR_LR = 1e-4
# prefill logits, TP against one card: the same one-card program already
# disagrees with itself by 2-6 % (relative L2) between batch 4 and batch 1
# at llama2-1b width in bf16 (other GEMM tilings); the bound of the
# repo's TP tests
TP_LOGIT_RTOL = 5e-2
# logit distance from the argmax that numerical noise may take: ~1.1 std
# of llama2-1b's random-init logits (0.02 * sqrt(2048) = 0.9); a token
# from the wrong slot or position sits ~4 std (3.6) below the argmax
TIE_LOGITS = 1.0

failures: list[str] = []


def report(phase: str, ok: bool, **fields) -> None:
    if not ok:
        failures.append(phase)
    print(f"{phase}: ok={ok} " + json.dumps(fields, default=str), flush=True)


def card_phase() -> None:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(out, flush=True)


def gpu_tests_phase() -> None:
    env = {**os.environ, "JAX_PLATFORMS": "cuda"}
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "tests/", "-q",
         "-p", "no:cacheprovider", "-rfEs"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900,
    )
    lines = r.stdout.strip().splitlines()
    summary = lines[-1] if lines else r.stderr.strip()[-300:]
    ok = r.returncode == 0 and "skipped" not in summary and "passed" in summary
    if not ok:
        print("\n".join(lines[-60:]) + "\n" + r.stderr[-2000:], flush=True)
    report("gpu-tests", ok, summary=summary,
           not_passed=[ln for ln in lines if ln.startswith(("FAILED", "ERROR", "SKIPPED"))])


def pretrain_argv(scheme, kwargs, *, batch=BATCH, steps=STEPS, extra=()):
    argv = [
        "--model", "llama2-1b", "--seq_len", str(SEQ),
        "--batch_size", str(batch), "--activation_checkpointing",
        "--train_ds", '{"type":"markov"}', "--n_steps", str(steps),
        "--log_interval", "1", "--ckpt_interval", "0",
        "--save_dir", str(REPO / "runs" / "chip_smoke"), *extra,
    ]
    if scheme:
        argv += ["--quantize", scheme, "--quantize_kwargs", json.dumps(kwargs)]
    return argv


def train_phase(schemes=SCHEMES, argv_fn=pretrain_argv) -> dict:
    import llm_pretrain

    runs = {}
    for name, (scheme, kwargs) in schemes.items():
        s = llm_pretrain.main(argv_fn(scheme, kwargs))
        runs[name] = s
        losses = s["losses"]
        ok = len(losses) > 0 and all(math.isfinite(x) for x in losses)
        if name != "bf16" and scheme != "bitnet" and "bf16" in runs:
            gap = abs(losses[0] - runs["bf16"]["losses"][0])
            ok = ok and gap <= LOSS_BAND
        report(
            f"train {name}", ok,
            compile_s=round(s["compile_s"], 2),
            step_ms=[round(t, 2) for t in s["step_ms"]],
            peak_bytes_in_use=s["peak_bytes_in_use"],
            memory_analysis=s.get("memory_analysis"),
            losses=[round(x, 5) for x in losses],
        )
    return runs


def _teacher_forced(params, cfg, prompts, streams):
    """Per stream: the largest gap between the reference's top logit and the
    logit of the token the stream chose, where it lies, and how many of the
    stream's tokens are the reference's argmax. The reference runs every
    prompt + stream through one batched prefill with the plain cache-einsum
    attention."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from quantized_training_tpu.models import llama_infer

    seqs = [list(p) + list(s) for p, s in zip(prompts, streams)]
    L = max(len(q) for q in seqs)
    tokens = np.zeros((len(seqs), L), np.int32)
    for i, q in enumerate(seqs):
        tokens[i, : len(q)] = q

    @jax.jit
    def logits_of(params, tokens):
        cache = llama_infer.KVCache.zeros(cfg, *tokens.shape)
        return llama_infer.forward_with_cache(
            params, tokens, cache, 0, cfg, flash_prefill=False
        )[0]

    logits = np.asarray(logits_of(params, jnp.asarray(tokens)), np.float32)
    out = []
    for i, (p, s) in enumerate(zip(prompts, streams)):
        s = np.asarray(s)
        row = logits[i, np.arange(len(p) - 1, len(p) - 1 + len(s))]
        gap = row.max(-1) - row[np.arange(len(s)), s]
        out.append((float(gap.max()), int(gap.argmax()), int((row.argmax(-1) == s).sum())))
    return out


def _gap_fields(name, tf):
    """Report fields for one group of teacher-forced streams."""
    worst = max(range(len(tf)), key=lambda i: tf[i][0])
    return {
        f"max_gap_{name}": tf[worst][0],
        f"worst_{name}": {"stream": worst, "position": tf[worst][1]},
        f"argmax_tokens_{name}": sum(t[2] for t in tf),
    }


def serve_phase(cfg=None, prompt_lens=(32, 96, 224, 480),
                budgets=(32, 64, 96, 128), gen_prompt=(4, 512), gen_new=32,
                n_slots=8, seed=0) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from quantized_training_tpu import quant
    from quantized_training_tpu.models import llama, llama_infer
    from quantized_training_tpu.models.serving import Server

    cfg = cfg or llama.LLAMA2_1B
    params = llama.init_params(jax.random.PRNGKey(seed), cfg)
    params = quant.quantize_params(params, "int8_quantized_training")
    gen = jax.jit(llama_infer.generate, static_argnums=(2, 3))

    rng = np.random.default_rng(seed)
    prompts = rng.integers(1, cfg.vocab_size, gen_prompt, dtype=np.int32)
    t0 = time.perf_counter()
    out = np.asarray(gen(params, jnp.asarray(prompts), cfg, gen_new))
    gen_s = time.perf_counter() - t0
    shape_ok = out.shape == (gen_prompt[0], gen_prompt[1] + gen_new) and (
        out[:, : gen_prompt[1]] == prompts
    ).all() and ((0 <= out) & (out < cfg.vocab_size)).all()

    # 16 requests: 4 prompt lengths x 4 budgets, each length batched once
    # through generate()
    reqs = [
        (rng.integers(1, cfg.vocab_size, n).tolist(), b)
        for n in prompt_lens for b in budgets
    ]
    ref = {}
    for n in prompt_lens:
        group = [i for i, (p, _) in enumerate(reqs) if len(p) == n]
        toks = np.asarray(gen(params, jnp.asarray([reqs[i][0] for i in group]), cfg, max(budgets)))
        for row, i in enumerate(group):
            ref[i] = toks[row, n:].tolist()

    # decode_chunk=1: one decode program per attention window (chunked
    # decode, which compiles one per window and chunk size, is checked
    # against single-step decode in tests/test_serving.py)
    srv = Server(params, cfg, n_slots=n_slots,
                 max_len=max(prompt_lens) + max(budgets) + 1, decode_chunk=1)
    t0 = time.perf_counter()
    rids = [srv.add_request(p, max_new_tokens=b) for p, b in reqs]
    n_tokens = 0
    while srv.pending():
        n_tokens += len(srv.step())
    serve_s = time.perf_counter() - t0

    got = [srv.result(rid) for rid in rids]
    want = [ref[i][: b] for i, (_, b) in enumerate(reqs)]
    n = len(reqs)
    tf = _teacher_forced(
        params, cfg,
        [p for p, _ in reqs] * 2 + prompts.tolist(),
        got + want + out[:, gen_prompt[1]:].tolist(),
    )
    gen_tf = tf[n:]
    report(
        "serve generate",
        shape_ok and max(t[0] for t in gen_tf) <= TIE_LOGITS,
        shape=list(out.shape), seconds_incl_compile=round(gen_s, 2),
        **_gap_fields("generate", gen_tf),
    )
    report(
        "serve server",
        max(t[0] for t in tf[:n]) <= TIE_LOGITS and [len(g) for g in got] == [b for _, b in reqs],
        requests=n, tokens=n_tokens, seconds_incl_compile=round(serve_s, 2),
        decode_programs=len(srv._decode_fns),
        streams_equal_to_generate=sum(g == w for g, w in zip(got, want)),
        **_gap_fields("server", tf[:n]),
    )


def vit_phase(argv=None) -> None:
    import vit_train

    argv = argv or [
        "--model", "vit_base", "--batch_size", "64", "--image_size", "224",
        "--num_classes", "1000", "--quantize", "mixed_precision",
        "--n_steps", "1", "--log_interval", "1",
        "--train_ds", '{"type":"synthetic_image"}',
    ]
    s = vit_train.main(argv)
    ok = len(s["losses"]) == 1 and math.isfinite(s["losses"][0])
    report("vit", ok, losses=s["losses"], step_ms_incl_compile=s["step_ms"])


def four_argv(scheme, kwargs, mesh_axes):
    extra = ["--lr", str(FOUR_LR)]
    if mesh_axes:
        extra += ["--mesh", json.dumps(mesh_axes)]
    return pretrain_argv(scheme, kwargs, batch=8, steps=3, extra=extra)


def four_phase(cfg=None, argv_fn=four_argv, prompt_shape=(4, 512), new=32) -> None:
    """FSDP training, BitNet's 2-bit all-gather and TP serving over four
    cards, each against the same work on one card in this process."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    import llm_pretrain
    from quantized_training_tpu.models import llama, llama_infer
    from quantized_training_tpu.parallel import make_mesh, shard_params_tp, shard_state

    cfg = cfg or llama.LLAMA2_1B
    # every shard of a stacked weight on its own card
    mesh = make_mesh({"fsdp": 4})
    w = shard_state(jnp.zeros((cfg.num_hidden_layers, cfg.hidden_size, cfg.hidden_size)), mesh)
    devs = {s.device for s in w.addressable_shards}
    report("four placement", len(devs) == 4, devices=sorted(str(d) for d in devs))

    def sharded_vs_one(scheme, meshes):
        one = llm_pretrain.main(argv_fn(scheme, {}, None))
        for axes in meshes:
            s = llm_pretrain.main(argv_fn(scheme, {}, axes))
            gap = max(abs(a - b) for a, b in zip(s["losses"], one["losses"]))
            report(
                f"four {scheme} {json.dumps(axes)}", gap <= FOUR_LOSS_TOL,
                losses=s["losses"], one_card=one["losses"], max_gap=gap,
                step_ms=s["step_ms"], compile_s=s["compile_s"],
            )

    sharded_vs_one("mixed_precision", ({"fsdp": 4}, {"data": 2, "fsdp": 2}))

    params = llama.init_params(jax.random.PRNGKey(0), cfg)
    prompt = jax.random.randint(jax.random.PRNGKey(1), prompt_shape, 0, cfg.vocab_size, jnp.int32)
    tp = make_mesh({"model": 4})
    p_tp = shard_params_tp(params, tp)
    prompt_tp = jax.device_put(prompt, NamedSharding(tp, P()))
    n = prompt_shape[1]

    prefill = jax.jit(lambda p, t, mesh=None: llama_infer.prefill(p, t, cfg, n, mesh)[0],
                      static_argnames="mesh")
    ref = np.asarray(prefill(params, prompt), np.float32)
    got = np.asarray(prefill(p_tp, prompt_tp, mesh=tp), np.float32)
    rows = np.concatenate([np.asarray(prefill(params, prompt[i:i + 1]), np.float32)
                           for i in range(prompt_shape[0])])
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    gen = jax.jit(llama_infer.generate, static_argnums=(2, 3), static_argnames="mesh")
    t_one = np.asarray(gen(params, prompt, cfg, new))[:, n:]
    t_tp = np.asarray(gen(p_tp, prompt_tp, cfg, new, mesh=tp))[:, n:]
    tf = _teacher_forced(params, cfg, np.asarray(prompt).tolist(), t_tp.tolist())
    report(
        "four tp-serve",
        rel(got, ref) <= TP_LOGIT_RTOL and max(t[0] for t in tf) <= TIE_LOGITS,
        prefill_logits_rel_l2=rel(got, ref), one_card_batch4_vs_batch1=rel(ref, rows),
        greedy_tokens_matching=int((t_one == t_tp).sum()), greedy_tokens=t_one.size,
        **_gap_fields("tp", tf),
    )
    sharded_vs_one("bitnet", ({"fsdp": 4},))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths and their one-card references")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four else 1

    card_phase()
    if not args.four:
        gpu_tests_phase()

    from quantized_training_tpu.utils.runtime import device_info, setup_compile_cache

    info = device_info()
    if info["platform"] != "gpu" or info["count"] < n_cards:
        print(f"needs {n_cards} GPU(s); JAX found {info}", file=sys.stderr)
        return 1
    setup_compile_cache()
    print(f"device_kind: {info['kind']}", flush=True)

    if args.four:
        four_phase()
    else:
        train_phase()
        serve_phase()
        vit_phase()

    if failures:
        print(f"failed phases: {failures}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
