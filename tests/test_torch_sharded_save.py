"""The sharded save (ROADMAP A5.5b) against the JAX package, on the CPU.

A train step's ``state_for_checkpoint()`` over mp, ZeRO and ep holds each
split array as a ``ShardedTensor`` of the live block, and a
``CheckpointManager`` save writes each rank's replica-0 blocks with no
collective, as the JAX package writes a sharded ``jax.Array``. Two gloo
ranks (``Ranks``, the ``sharded_save2`` job of ``tests/torch_dist_jobs.py``,
at most 60 s) train the tiny GPT at mp 2 and at ZeRO-3 (``p_g_os``)
sharding 2 and the tiny GPT-MoE at ep 2 two steps each and save; then:

- the save made no tensor collective, and each rank wrote exactly its
  replica-0 blocks (its block of every split array, and on rank 0 the
  whole ones), the two together every array once;
- the JAX package's ``load_tree`` restores it, whole and onto the JAX mesh
  of the same placements, bitwise equal to the step's state gathered by
  the explicit gather (``resharding.gather_tree``);
- every array whose block is one box a rank has the file names, offsets
  and CRC32s of the JAX package's own save of the same arrays on the same
  placements (the qkv projection's mp blocks are three boxes a rank, one
  per segment, and the JAX reader assembles them by their offsets);
- a step built on other weights restores it (each rank reading its
  blocks) and its third step's loss is the JAX step's third within
  ``LOSS_TOL``;
- ``framework.io.save_sharded`` of the mp-2 state across the ranks writes
  the same shard files under one merged manifest.
"""

import os

import jax
import numpy as np
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from paddle_tpu import checkpoint as jckpt

import test_torch_dist_ranks as R
from test_torch_distributed import (LOSS_TOL, _batches, _jax_model,
                                    _reset_jax_world)
from test_torch_expert_parallel import _jax_moe_step
from test_torch_moe import _jax_model as _moe_jax_model
from test_torch_tensor_parallel import _jax_step, _mesh

CASES = ("mp", "zero3", "ep")


def _jax_losses(key, xs, ys):
    _reset_jax_world()
    if key == "mp":
        step = _jax_step(_mesh((2,), ("mp",)))
    elif key == "zero3":
        step = _jax_step(_mesh((2,), ("sharding",)), level="p_g_os")
    else:
        step = _jax_moe_step(_mesh((2,), ("ep",)))
    return [float(step(xs[k], ys[k])) for k in range(3)]


def _jax_sharding(desc):
    """The JAX ``NamedSharding`` of a manifest's ``sharding`` entry."""
    n = int(np.prod(desc["mesh_shape"]))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(desc["mesh_shape"]),
                tuple(desc["mesh_axes"]))
    return NamedSharding(mesh, P(*[tuple(e) if isinstance(e, list) else e
                                   for e in desc["spec"]]))


def _boxes(desc):
    """The blocks of a placement: one per combination of the coordinates
    of the axes its spec splits over."""
    sizes = dict(zip(desc["mesh_axes"], desc["mesh_shape"]))
    axes = [a for e in desc["spec"] if e is not None
            for a in (e if isinstance(e, list) else [e])]
    return int(np.prod([sizes[a] for a in axes]))


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        a.tobytes() == b.tobytes()


def _check_save(ckpt, gathered, tmp_path, key):
    step_dir = os.path.join(ckpt, "step_00000002")
    manifest = jckpt.arrays.read_manifest(step_dir)
    want = {p: v.numpy() for p, v in _flat(gathered).items()
            if isinstance(v, torch.Tensor)}
    # the JAX package's restore, whole: every array bitwise
    whole = _flat(jckpt.CheckpointManager(ckpt).restore())
    for path, v in want.items():
        assert _bitwise(whole[path], v), (key, path)
    sharded = {p: e for p, e in manifest["arrays"].items()
               if e["sharding"] is not None}
    assert sharded, key
    # ... and onto the JAX mesh of each array's placement
    placed = _flat(jckpt.load_tree(step_dir, shardings=_nest({
        p: _jax_sharding(e["sharding"]) for p, e in sharded.items()})))
    for path in sharded:
        assert _bitwise(placed[path], want[path]), (key, path)
    # the JAX package's own save of the same arrays on the same placements
    one_box = {p for p, e in sharded.items()
               if len(e["shards"]) == _boxes(e["sharding"])}
    assert one_box, key
    jdir = str(tmp_path / f"jax_{key}")
    jm = jckpt.arrays.save_tree(jdir, _nest({
        p: jax.device_put(want[p], _jax_sharding(sharded[p]["sharding"]))
        for p in one_box}))
    for path in one_box:
        mine = {(s["file"], tuple(s["offset"]), s["crc32"])
                for s in manifest["arrays"][path]["shards"]}
        theirs = {(s["file"], tuple(s["offset"]), s["crc32"])
                  for s in jm["arrays"][path]["shards"]}
        assert mine == theirs, (key, path, mine, theirs)
    # the segmented qkv: three boxes a rank, as the JAX reader takes them
    qkv = [e for p, e in sharded.items() if p.endswith("attn.qkv.weight")
           and p.startswith("params")]
    if key == "mp":
        assert all(len(e["shards"]) == 6 for e in qkv)


def test_sharded_save_matches_the_reference(tmp_path):
    _, params = _jax_model()
    _, moe_params = _moe_jax_model()
    xs, ys = _batches()
    torch.save({"params": params, "x": torch.from_numpy(xs),
                "y": torch.from_numpy(ys),
                "moe_params": {k: torch.from_numpy(v)
                               for k, v in moe_params.items()}},
               tmp_path / "inputs.pt")
    with R.Ranks("sharded_save2", tmp_path) as ranks:
        losses = {key: _jax_losses(key, xs, ys) for key in CASES}
        outs = ranks.results()
    _reset_jax_world()
    for key in CASES:
        for r, out in enumerate(outs):
            got = out[key]
            assert got["collectives"] == [], (key, r, got["collectives"])
            assert got["sharded"] > 0
            assert got["bytes"] == got["expected"], (key, r, got)
            assert abs(got["resumed"] - losses[key][2]) <= LOSS_TOL, (
                key, got["resumed"], losses[key])
            # every rank gathers the same whole state
            assert all(torch.equal(a, b) for a, b in zip(
                _flat(got["gathered"]).values(),
                _flat(outs[0][key]["gathered"]).values()))
        gathered = outs[0][key]["gathered"]
        total = sum(v.numel() * v.element_size()
                    for v in _flat(gathered).values()
                    if isinstance(v, torch.Tensor))
        assert sum(o[key]["bytes"] for o in outs) == total, key
        _check_save(str(tmp_path / f"{key}_ck"), gathered, tmp_path, key)
    # framework.io.save_sharded across the ranks: the same files, one
    # manifest, read bitwise by the JAX package
    io_dir = tmp_path / "mp_io"
    assert not list(io_dir.glob("manifest.part*"))
    ck = jckpt.arrays.read_manifest(str(tmp_path / "mp_ck" / "step_00000002"))
    io = jckpt.arrays.read_manifest(str(io_dir))
    assert {p: e["shards"] for p, e in io["arrays"].items()} == {
        p: e["shards"] for p, e in ck["arrays"].items()}
    back = _flat(jckpt.arrays.load_tree(str(io_dir)))
    assert all(_bitwise(back[p], v.numpy()) for p, v in
               _flat(outs[0]["mp"]["gathered"]).items()
               if isinstance(v, torch.Tensor))
