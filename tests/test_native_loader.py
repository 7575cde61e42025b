"""Native C++ token loader tests; the library is built from
cpp/tokenloader.cpp (``make native``) by a fixture."""

import subprocess
from pathlib import Path

import numpy as np
import pytest

from quantized_training_tpu.data import native_loader


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(0)
    for i in range(3):
        rng.integers(0, 1000, 650, dtype=np.uint16).tofile(d / f"s{i}.bin")
    return d


@pytest.fixture(scope="module", autouse=True)
def built_library():
    if not native_loader.available():
        repo = Path(__file__).resolve().parent.parent
        subprocess.run(["make", "-s", "native"], cwd=repo, check=True, timeout=300)
    assert native_loader.available()


class TestNativeLoader:
    def test_batches_and_window_shift(self, shard_dir):
        dl = native_loader.NativeTokenLoader(shard_dir, seq_len=32, batch_size=4, seed=1)
        it = iter(dl)
        tokens, labels = next(it)
        assert tokens.shape == (4, 32) and tokens.dtype == np.int32
        np.testing.assert_array_equal(tokens[:, 1:], labels[:, :-1])
        dl.close()

    def test_deterministic_given_seed(self, shard_dir):
        a = native_loader.NativeTokenLoader(shard_dir, seq_len=32, batch_size=4, seed=7)
        b = native_loader.NativeTokenLoader(shard_dir, seq_len=32, batch_size=4, seed=7)
        for _ in range(5):
            (ta, _), (tb, _) = next(iter(a)), next(iter(b))
            np.testing.assert_array_equal(ta, tb)
        a.close(), b.close()

    def test_state_resume(self, shard_dir):
        a = native_loader.NativeTokenLoader(shard_dir, seq_len=32, batch_size=4, seed=3)
        it = iter(a)
        for _ in range(4):
            next(it)
        state = a.state_dict()
        expected = [next(it)[0] for _ in range(3)]

        b = native_loader.NativeTokenLoader(shard_dir, seq_len=32, batch_size=4, seed=3)
        b.load_state_dict(state)
        got = [next(iter(b))[0] for _ in range(3)]
        for e, g in zip(expected, got):
            np.testing.assert_array_equal(e, g)
        a.close(), b.close()

    def test_eval_mode_finite_and_ordered(self, shard_dir):
        dl = native_loader.NativeTokenLoader(
            shard_dir, seq_len=32, batch_size=4, seed=0, eval=True
        )
        batches = list(dl)
        # 3 shards x floor(650/33)=19 windows = 57 -> 14 batches of 4
        assert len(batches) == 14
        first = batches[0][0]
        # eval order is sequential: first window starts at token 0
        assert first[0, 0] is not None
        dl.close()

    def test_epoch_rollover(self, shard_dir):
        dl = native_loader.NativeTokenLoader(shard_dir, seq_len=32, batch_size=8, seed=5)
        it = iter(dl)
        for _ in range(20):  # 57 windows / 8 = 7 per epoch -> crosses epochs
            next(it)
        assert dl.state_dict()["epoch"] >= 2
        dl.close()
