"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``) on the CPU.

The tree is ``tests/test_fault_tolerance.py``'s (f32, f64, int32 and
bf16 leaves) plus a 4-D f32 leaf, a larger f64 leaf and a nested list,
made from seeds with numpy (the bf16 values are exact in bf16, so both
packages hold the same bits).  For each of the ``lopc-v2``,
``lopc-lossless`` and ``raw`` codecs: the port writes the reference's
leaf files byte for byte and its manifest apart from ``"treedef"``; each
package restores the other's checkpoint to the same bits.  A legacy
``lopc-lossy`` checkpoint written by the reference restores to the
reference's values.  The port alone is held to the reference tests'
contracts: crc corruption raises, the atomic publish, retention with an
async save (also against in-place updates after ``save``), a corrupt
latest step skipped, and an elastic restore onto a 2-rank gloo mesh with
``Shard(0)``, whose DTensor leaves save back to the same files.
"""
from __future__ import annotations

import json
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (
    CheckpointManager,
    available_steps,
    restore_tree,
    save_tree,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_distributed import run_ranks  # noqa: E402

EB = 1e-3
SETTINGS = {
    # codec setting -> save_tree keywords
    "lopc-v2": {"eb": EB},
    "lopc-lossless": {},
    "raw": {"codec": "raw"},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module (see test_torch_temporal.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_exact(a: np.ndarray) -> np.ndarray:
    """f32 values whose low 16 bits are zero: exact in bf16."""
    return (a.astype(np.float32).view(np.uint32) & np.uint32(0xFFFF0000)
            ).view(np.float32)


def tree_np(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((64, 32)).astype(np.float32),
        "b": rng.standard_normal((256,)).astype(np.float64),
        "emb": (rng.standard_normal((128, 16)) * 0.02).astype(np.float32),
        "step": np.asarray(7, np.int32),
        "bf": _bf16_exact(rng.standard_normal((8, 8))),
        "x4": rng.standard_normal((4, 6, 8, 10)).astype(np.float32),
        "c": [np.cumsum(rng.standard_normal((48, 40)), 1),
              rng.integers(-5, 5, (10,)).astype(np.int32)],
    }


def as_port(t: dict) -> dict:
    out = {k: torch.from_numpy(np.array(v)) for k, v in t.items() if k != "c"}
    out["bf"] = out["bf"].to(torch.bfloat16)
    out["c"] = [torch.from_numpy(v.copy()) for v in t["c"]]
    return out


def as_ref(t: dict) -> dict:
    import jax.numpy as jnp

    out = {k: jnp.asarray(v) for k, v in t.items() if k != "c"}
    out["bf"] = out["bf"].astype(jnp.bfloat16)
    out["c"] = [jnp.asarray(v) for v in t["c"]]
    return out


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes()
    x = np.asarray(x)
    return (x.view(np.int16) if x.dtype.name == "bfloat16" else x).tobytes()


def _leaves(tree) -> list:
    return [tree[k] for k in ("b", "bf", "emb", "step", "w", "x4")] + tree["c"]


def _files(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_port_writes_the_references_files(setting, tmp_path):
    from repro.checkpoint import manager as ref

    kw = SETTINGS[setting]
    m = save_tree(as_port(tree_np()), tmp_path / "pt", 3, device="cpu", **kw)
    m_ref = ref.save_tree(as_ref(tree_np()), tmp_path / "ref", 3, **kw)
    assert setting in {leaf["codec"] for leaf in m["leaves"]}
    got, want = _files(tmp_path / "pt" / "step_3"), _files(tmp_path / "ref" / "step_3")
    assert got.keys() == want.keys() and len(got) == 9
    for name in got:
        if name != "manifest.json":
            assert got[name] == want[name], name
    mj, mj_ref = (json.loads(f["manifest.json"]) for f in (got, want))
    assert mj.pop("treedef") != mj_ref.pop("treedef")
    assert mj == mj_ref
    m.pop("treedef"), m_ref.pop("treedef")
    assert m == m_ref
    assert [leaf["path"] for leaf in mj["leaves"]][:3] == \
        ["['b']", "['bf']", "['c'][0]"]


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_checkpoints_cross_restore(setting, tmp_path):
    """The reference restores the port's checkpoint and the port the
    reference's, each to the bits the writer's own package restores."""
    from repro.checkpoint import manager as ref

    kw = SETTINGS[setting]
    save_tree(as_port(tree_np()), tmp_path / "pt", 1, device="cpu", **kw)
    ref.save_tree(as_ref(tree_np()), tmp_path / "ref", 1, **kw)
    tmpl_pt, tmpl_ref = as_port(tree_np()), as_ref(tree_np())
    own, step = restore_tree(tmpl_pt, tmp_path / "pt", device="cpu")
    assert step == 1
    by_ref, _ = ref.restore_tree(tmpl_ref, tmp_path / "pt")
    from_ref, _ = restore_tree(tmpl_pt, tmp_path / "ref", device="cpu")
    ref_own, _ = ref.restore_tree(tmpl_ref, tmp_path / "ref")
    for a, b, c, d in zip(_leaves(own), _leaves(by_ref), _leaves(from_ref),
                          _leaves(ref_own)):
        assert _bits(a) == _bits(b) == _bits(c) == _bits(d)
    assert own["bf"].dtype == torch.bfloat16 and own["step"].shape == ()
    x = tree_np()
    for k in ("w", "emb", "x4"):
        err = np.abs(own[k].numpy() - x[k]).max()
        if setting == "lopc-v2":
            assert 0 < err <= EB
        else:
            assert err == 0


def test_legacy_lossy_checkpoint_restores_to_the_references_values(tmp_path):
    from repro.checkpoint import manager as ref

    ref.save_tree(as_ref(tree_np()), tmp_path, 2, eb=EB, codec="lopc-lossy")
    assert "lopc-lossy" in (tmp_path / "step_2" / "manifest.json").read_text()
    want, _ = ref.restore_tree(as_ref(tree_np()), tmp_path)
    got, _ = restore_tree(as_port(tree_np()), tmp_path, device="cpu")
    for a, b in zip(_leaves(got), _leaves(want)):
        assert _bits(a) == _bits(b)
    assert np.abs(got["w"].numpy() - tree_np()["w"]).max() <= EB


def test_crc_detects_corruption(tmp_path):
    tree = as_port(tree_np())
    save_tree(tree, tmp_path, 1, device="cpu")
    victim = tmp_path / "step_1" / "leaf_0.bin"
    raw = bytearray(victim.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    victim.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="corrupt"):
        restore_tree(tree, tmp_path, 1, device="cpu")


def test_partial_tmp_dir_is_invisible(tmp_path):
    tree = as_port(tree_np())
    save_tree(tree, tmp_path, 5, device="cpu")
    fake = tmp_path / "step_9.tmp-999"
    fake.mkdir()
    (fake / "leaf_0.bin").write_bytes(b"partial")
    assert available_steps(tmp_path) == [5]
    restored, step = CheckpointManager(tmp_path, device="cpu").restore_latest(tree)
    assert step == 5 and _bits(restored["w"]) == _bits(tree["w"])


def test_manager_retention_and_async_save(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=True, device="cpu")
    tree = as_port(tree_np())
    before = _bits(tree["w"])
    for s in range(5):
        mgr.save(s, tree)
        tree["w"].add_(1.0)  # in place, while the save may still run
    mgr.wait()
    assert available_steps(tmp_path) == [3, 4]
    restored, step = mgr.restore_latest(as_port(tree_np()))
    want = np.frombuffer(before, np.float32).reshape(64, 32).copy()
    for _ in range(4):
        want += np.float32(1.0)
    assert step == 4 and restored["w"].numpy().tobytes() == want.tobytes()
    assert mgr.last_manifest["step"] == 4


def test_manager_skips_a_corrupt_latest(tmp_path):
    tree = as_port(tree_np())
    save_tree(tree, tmp_path, 1, device="cpu")
    save_tree(tree, tmp_path, 2, device="cpu")
    (tmp_path / "step_2" / "leaf_0.bin").write_bytes(b"garbage")
    _, step = CheckpointManager(tmp_path, device="cpu").restore_latest(tree)
    assert step == 1


_ELASTIC = textwrap.dedent("""
    import pickle, sys
    from pathlib import Path
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, out, tests, ckpt = sys.argv[3], Path(sys.argv[4]), sys.argv[5], sys.argv[6]
    sys.path.insert(0, tests)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Replicate, Shard
        from repro_torch.checkpoint import restore_tree, save_tree
        import test_torch_checkpoint as T

        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        tmpl = T.as_port(T.tree_np())
        shard0 = (mesh, [Shard(0)])
        shardings = {k: shard0 for k in tmpl if k != "c"}
        shardings["step"] = (mesh, [Replicate()])
        shardings["c"] = [shard0, (mesh, [Replicate()])]
        tree, step = restore_tree(tmpl, ckpt, shardings=shardings, device="cpu")
        local = {k: tree[k].to_local() for k in ("w", "x4", "bf")}
        # DTensor leaves save back gathered, to the same files
        save_tree(tree, out.parent / f"resave{rank}", step, device="cpu")
        out.write_bytes(pickle.dumps(
            (step, {k: T._bits(v) for k, v in local.items()},
             {k: tuple(v.shape) for k, v in local.items()})))
    finally:
        dist.destroy_process_group()
""")


def test_elastic_restore_onto_a_two_rank_mesh(tmp_path):
    tree = as_port(tree_np())
    save_tree(tree, tmp_path / "ckpt", 6, device="cpu")
    res = run_ranks(2, tmp_path / "ranks", _ELASTIC, str(tmp_path / "ckpt"))
    for rank, (step, local, shapes) in enumerate(res):
        assert step == 6
        for k in ("w", "x4", "bf"):
            rows = tree[k].shape[0] // 2
            assert shapes[k] == (rows,) + tuple(tree[k].shape[1:])
            assert local[k] == _bits(tree[k][rank * rows:(rank + 1) * rows])
        resaved = _files(tmp_path / "ranks" / f"resave{rank}" / "step_6")
        assert resaved == _files(tmp_path / "ckpt" / "step_6")
