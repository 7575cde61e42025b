"""chip_smoke.py's phases at tiny widths on the CPU, and its refusal to run
without a GPU."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from quantized_training_tpu.models import llama  # noqa: E402

TINY = '{"hidden_size":128,"intermediate_size":256,"num_hidden_layers":2,' \
       '"num_attention_heads":4,"num_key_value_heads":2,"vocab_size":512}'


@pytest.fixture(autouse=True)
def fresh_failures(monkeypatch):
    monkeypatch.setattr(chip_smoke, "failures", [])
    cache = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", cache)


def tiny_argv(scheme, kwargs, tmp):
    argv = [
        "--model_kwargs", TINY, "--seq_len", "64", "--batch_size", "2",
        "--activation_checkpointing", "--train_ds", '{"type":"markov"}',
        "--n_steps", "2", "--log_interval", "1", "--ckpt_interval", "0",
        "--save_dir", str(tmp),
    ]
    if scheme:
        argv += ["--quantize", scheme, "--quantize_kwargs", json.dumps(kwargs)]
    return argv


def test_refuses_cpu(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "card_phase", lambda: None)
    monkeypatch.setattr(chip_smoke, "gpu_tests_phase", lambda: None)
    assert chip_smoke.main([]) == 1
    assert '"ok"' not in capsys.readouterr().out


def test_refuses_four_cards_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "card_phase", lambda: None)
    assert chip_smoke.main(["--four"]) == 1
    assert '"ok"' not in capsys.readouterr().out


def test_alone_fails_without_result(tmp_path):
    """Outside a checkout (and with no card) the script exits non-zero and
    prints no result line."""
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("names", [
    ("bf16", "int8-mp"),
    ("bf16", "int8-mp-sr", "fp8-row"),
    ("bf16", "fp8-tile", "int8-qt"),
    ("bf16", "int4-wo", "bitnet"),
], ids=lambda n: "+".join(n))
def test_train_phase_tiny(tmp_path, names):
    schemes = {n: chip_smoke.SCHEMES[n] for n in names}
    runs = chip_smoke.train_phase(
        schemes, argv_fn=lambda s, kw: tiny_argv(s, kw, tmp_path)
    )
    assert chip_smoke.failures == []
    for s in runs.values():
        assert len(s["losses"]) == 2 and len(s["step_ms"]) == 2
        assert s["compile_s"] > 0 and "temp_size_in_bytes" in s["memory_analysis"]


def test_train_phase_flags_loss_outside_band(tmp_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "LOSS_BAND", -1.0)
    schemes = {n: chip_smoke.SCHEMES[n] for n in ("bf16", "int8-mp")}
    chip_smoke.train_phase(schemes, argv_fn=lambda s, kw: tiny_argv(s, kw, tmp_path))
    assert chip_smoke.failures == ["train int8-mp"]


def test_serve_phase_tiny():
    cfg = llama.LlamaConfig(
        vocab_size=256, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    )
    chip_smoke.serve_phase(cfg, prompt_lens=(5, 12), budgets=(3, 6),
                           gen_prompt=(2, 16), gen_new=4, n_slots=3)
    assert chip_smoke.failures == []


def test_vit_phase_tiny(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    chip_smoke.vit_phase([
        "--model", "vit_tiny", "--batch_size", "2", "--image_size", "32",
        "--model_kwargs", '{"patch_size": 8, "hidden_size": 128, "num_layers": 1, "num_heads": 2}',
        "--num_classes", "10", "--quantize", "mixed_precision",
        "--n_steps", "1", "--log_interval", "1",
        "--train_ds", '{"type":"synthetic_image"}',
    ])
    assert chip_smoke.failures == []


def test_four_phase_tiny(tmp_path):
    """The four-card phase on four of the virtual CPU devices: FSDP and
    data x FSDP int8 training, BitNet's 2-bit all-gather and TP serving,
    each against one device."""
    def argv(scheme, kwargs, axes):
        a = tiny_argv(scheme, kwargs, tmp_path)
        a[a.index("--batch_size") + 1] = "8"
        return a + (["--mesh", json.dumps(axes)] if axes else [])

    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                            num_hidden_layers=2, num_attention_heads=4,
                            num_key_value_heads=4)
    chip_smoke.four_phase(cfg, argv, prompt_shape=(4, 16), new=4)
    assert chip_smoke.failures == []
