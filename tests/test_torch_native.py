"""The port's native scene bank and streamed DLP resets, on the CPU: the
library builds; its gather and prefetch equal the rows of ``data/dlp.npz``
and the numpy plain version; its ``.htpb`` file is byte-equal to the JAX
package's converter's; ``StreamingDLP`` equals the resident ``DLPDataset``
for the same ids and draws; a streamed ``ScenePool`` keeps the one-refresh
lag of ``hope_tpu/train/scene_pool.py`` (after ``tests/test_native.py``).
All comparisons exact.
"""
import os

import numpy as np
import pytest
import torch

from hope_tpu.native import convert_npz_to_bank as jconvert
from hope_tpu_torch import native
from hope_tpu_torch.config import EnvConfig, ObsConfig
from hope_tpu_torch.envs.dlp import DLPDataset, StreamingDLP
from hope_tpu_torch.envs.scene import Scene
from hope_tpu_torch.train.scene_pool import ScenePool

from .torch_threads import one_torch_thread  # noqa: F401

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
                   "dlp.npz")
CFG = EnvConfig(obs=ObsConfig(use_img=False), max_edges=512, max_obstacles=128)
FIELDS = [f for f in Scene.__dataclass_fields__]


def npz_rows(ids, E=None, S=None):
    with np.load(NPZ) as d:
        w = np.asarray(ids) % len(d["n_polys"])
        S = S or d["starts"].shape[1]
        return {"edges": d["edges"][w, :E], "edge_mask": d["edge_mask"][w, :E],
                "edge_poly": d["edge_poly"][w, :E], "n_polys": d["n_polys"][w],
                "dest": d["dest"][w], "starts": d["starts"][w, :S],
                "n_starts": np.minimum(d["n_starts"][w], S), "levels": d["levels"][w, :S]}


def assert_batch(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def bank_path():
    return native.bank_for(NPZ)


def test_bank_file_equals_jax_converter(bank_path, tmp_path):
    assert native.load_library() is not None
    jconvert(NPZ, str(tmp_path / "jax.htpb"))
    with open(bank_path, "rb") as a, open(tmp_path / "jax.htpb", "rb") as b:
        assert a.read() == b.read()
    assert os.path.dirname(bank_path) == native.BUILD_DIR


def test_gather_and_prefetch_equal_npz_rows(bank_path):
    rng = np.random.default_rng(0)
    bank = native.SceneBank(bank_path)
    assert (bank.n_cases, bank.max_edges, bank.max_starts) == (248, 8192, 128)
    ids = rng.integers(0, 300, 17)                      # wrap-around ids too
    assert_batch(bank.gather(ids, max_edges=512, max_starts=16), npz_rows(ids, 512, 16))
    assert_batch(native.gather_plain(bank_path, ids, 512, 16), npz_rows(ids, 512, 16))
    ids = rng.integers(0, 248, 70)                      # > 64: the threaded gather
    bank.prefetch(ids, max_edges=256, max_starts=8)
    with pytest.raises(RuntimeError, match="in flight"):
        bank.prefetch(ids)
    assert_batch(bank.take(), npz_rows(ids, 256, 8))
    bank.prefetch(ids[:4])                              # the lane is free again
    assert_batch(bank.take(), npz_rows(ids[:4]))
    with pytest.raises(RuntimeError, match="no prefetch"):
        bank.take()
    bank.close()
    with pytest.raises(RuntimeError, match="closed"):
        bank.gather(ids)


def test_build_failure_carries_compiler_message(monkeypatch, tmp_path):
    bad = tmp_path / "bad.cc"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ exit 1.*error: expected"):
        native._build()


def test_streaming_equals_resident(bank_path):
    """Same ids and DLPDraws: the same Scenes, field for field; through the
    prefetch too, and with draws from generators in the same state."""
    resident = DLPDataset(env_cfg=CFG, device="cpu")
    stream = StreamingDLP(env_cfg=CFG, device="cpu")
    ids = np.asarray([0, 3, 17, 101, 260])
    draws = resident.sample_draws(torch.as_tensor(ids), torch.Generator().manual_seed(9))
    a = resident.batch_reset(torch.as_tensor(ids), draws=draws)
    b = stream.batch_reset(ids, draws=draws)
    stream.prefetch(ids)
    c, used = stream.take_scenes(draws=draws)
    np.testing.assert_array_equal(used, ids % 248)
    d = stream.batch_reset(ids, torch.Generator().manual_seed(9))
    for f in FIELDS:
        for got in (b, c, d):
            assert torch.equal(getattr(got, f), getattr(a, f)), f
    with pytest.raises(RuntimeError, match="no prefetch"):
        stream.take_scenes(draws=draws)
    stream.close()


def test_stream_pool_keeps_one_refresh_lag():
    """Each refresh puts into the pool the cases the previous one asked for;
    with the same ids in flight and the same generator state, its DLP segment
    equals a resident pool's for those ids."""
    pool = ScenePool(CFG, per_level=4, stream_dlp=True, seed=3, device="cpu")
    assert pool.stream is not None and pool.dlp is None
    first = pool.dlp_case_ids.copy()
    np.testing.assert_array_equal(pool.pending_ids, first)     # cold start: same ids again
    want = np.asarray([5, 6, 7, 8])
    pool.refresh(dlp_case_ids=want)
    np.testing.assert_array_equal(pool.dlp_case_ids, first)
    np.testing.assert_array_equal(pool.pending_ids, want)
    resident = ScenePool(CFG, per_level=4, seed=3, device="cpu")
    resident.generator.set_state(pool.generator.get_state())
    pool.refresh(dlp_case_ids=np.asarray([1, 2, 3, 4]))
    np.testing.assert_array_equal(pool.dlp_case_ids, want)
    resident.refresh(dlp_case_ids=want)
    np.testing.assert_array_equal(resident.dlp_case_ids, want)
    for f in FIELDS:
        assert torch.equal(getattr(pool.pool, f), getattr(resident.pool, f)), f
    pool.stream.close()
