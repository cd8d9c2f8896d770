"""The port's resharding (``paddle_tpu_torch.distributed.resharding``) and
the checkpoint's restore onto another layout (ROADMAP A5.5a) against the
JAX package, on the CPU.

- The planner is the JAX package's, copied: ``shard_index_map`` over
  ``tests/test_resharding.py``'s ``SPEC_CASES``, ``plan_as_dict``,
  ``plan_sends`` and ``describe`` over its ``MOVES`` (with the identity
  and a reversed device order as well), and the same ``Unplannable``
  cases, each equal to the JAX planner's (which imports no JAX).
- The executor on 2 and 4 gloo ranks (``Ranks``, the ``reshard`` job of
  ``tests/torch_dist_jobs.py``): every hop of every chain bitwise the
  global array's slice, the bytes the ranks received summing to the
  plan's ``bytes_wire`` exactly; the ``(2, 2) -> (4,) -> (1,)`` chain, a
  device-order permutation, int64, bf16, the identity, the segmented qkv
  layout planned segment by segment, and a move no plan expresses taken
  by the counted gather-and-slice path.
- The checkpoint (the ``reshard_ckpt`` job, two ranks): the tiny GPT
  trained 2 steps at mp 2 and saved, restored onto a ``p_g_os`` step at
  sharding 2, each split leaf a ``ShardedTensor`` of its placement and
  bitwise the JAX ``load_tree(shardings=)`` block of the same placement;
  each rank reading exactly its blocks' bytes without validation, and
  every file they overlap whole with it (the same blocks); the files read
  onto the mp-2 placements and handed to the stage-3 step resharded there
  (the same blocks as plain tensors refused); the live restore from the
  mp-2 step's blocks bitwise the file path, its received bytes the
  plans' ``bytes_wire``; the run continued 2 steps
  within ``LOSS_TOL`` of the JAX step continued from the same save on the
  same mesh; and the JAX package's save of a ``(2, 2)`` ``("dp", "mp")``
  mesh (four devices' shards per leaf) restored onto the mp-2 step's
  placements bitwise.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as P

from paddle_tpu import checkpoint as jckpt
from paddle_tpu.distributed.resharding import planner as jplanner
from paddle_tpu.distributed.resharding import spec as jspec
from paddle_tpu_torch.distributed import DeviceMesh, NamedSharding
from paddle_tpu_torch.distributed import PartitionSpec as TP
from paddle_tpu_torch.distributed import resharding as rs
from paddle_tpu_torch.distributed.sharding_utils import local_block

import test_torch_dist_ranks as R
from test_resharding import MOVES, SPEC_CASES
from test_torch_distributed import LOSS_TOL, _bits, _reset_jax_world
from test_torch_expert_parallel import _torch_tree
from test_torch_tensor_parallel import _jax_model, _jax_step, _mesh

#: the executor's moves on two ranks: ``(shape, dtype, chain)``, each hop
#: ``(mesh axes, spec, reversed device order, segments)``
TWO = {
    "all_to_all": ((8, 6), torch.float32, [({"x": 2}, ["x", None]),
                                           ({"y": 2}, [None, "y"])]),
    "gather": ((8, 6), torch.float32, [({"x": 2}, ["x", None]),
                                       ({"y": 2}, [None, None])]),
    "slice": ((8, 6), torch.float32, [({"x": 2}, [None, None]),
                                      ({"y": 2}, [None, "y"])]),
    "permutation": ((8, 6), torch.float32, [({"x": 2}, ["x", None]),
                                            ({"y": 2}, ["y", None], True)]),
    "int64_identity": ((8, 6), torch.int64, [({"x": 2}, ["x", None]),
                                             ({"x": 2}, ["x", None]),
                                             ({"y": 2}, [None, "y"])]),
    "bf16": ((8, 6), torch.bfloat16, [({"x": 2}, [None, "x"]),
                                      ({"y": 2}, ["y", None])]),
    "to_one_rank": ((8, 6), torch.float32, [({"x": 2}, ["x", None]),
                                            ({"z": 1}, [None, None])]),
    "segments": ((6, 16), torch.float32, [
        ({"mp": 2}, [None, "mp"], False, {1: (8, 4, 4)}),
        ({"sharding": 2}, ["sharding", None])]),
    "segments_to_contiguous": ((16,), torch.float32, [
        ({"mp": 2}, ["mp"], False, {0: (8, 4, 4)}),
        ({"sharding": 2}, ["sharding"])]),
}
#: the four-rank moves: the JAX zoo's over four devices, the chain, a
#: permutation, int64 and the identity
FOUR = {
    **{f"zoo{i}": (m[0], torch.float32, [(m[1], m[2]), (m[3], m[4])])
       for i, m in enumerate(MOVES)
       if np.prod(list(m[1].values())) == 4},
    "chain": ((8, 8), torch.float32, [({"dp": 2, "mp": 2}, ["dp", "mp"]),
                                      ({"x": 4}, ["x", None]),
                                      ({"z": 1}, [None, None])]),
    "permutation": ((16, 4), torch.float32, [({"x": 4}, ["x", None]),
                                             ({"y": 4}, ["y", None], True)]),
    "int64_identity": ((8, 8), torch.int64, [
        ({"dp": 2, "mp": 2}, ["dp", None]), ({"dp": 2, "mp": 2}, ["dp", None]),
        ({"x": 4}, [None, "x"])]),
}


@pytest.fixture(autouse=True)
def _fresh():
    _reset_jax_world()
    rs.clear_caches()
    yield
    _reset_jax_world()


def _specs(mod, shape, sa, ss, da, ds):
    src = mod.ShardingSpec.make(mod.MeshSpec.make(sa), ss, len(shape))
    dst = mod.ShardingSpec.make(mod.MeshSpec.make(da), ds, len(shape))
    return src, dst


# ---------------- the planner: the JAX package's, case for case -----------
@pytest.mark.parametrize("shape,mshape,names,spec", SPEC_CASES)
def test_shard_index_map_matches_the_jax_planner(shape, mshape, names, spec):
    """The chunking of every device, and the port's block of each rank of
    a ``DeviceMesh`` (``block_pieces``) the same boxes."""
    axes = list(zip(names, mshape))
    entries = [e for e in spec]
    want = jspec.shard_index_map(shape, jspec.ShardingSpec.make(
        jspec.MeshSpec.make(axes), entries, len(shape)))
    got = rs.shard_index_map(shape, rs.ShardingSpec.make(
        rs.MeshSpec.make(axes), entries, len(shape)))
    assert got == want
    mesh = DeviceMesh(np.arange(int(np.prod(mshape))).reshape(mshape), names)
    sh = NamedSharding(mesh, TP(*entries))
    for pos, box in enumerate(want):
        [(g, _)] = rs.block_pieces(shape, sh, pos)
        assert tuple((s.start, s.stop) for s in g) == box


@pytest.mark.parametrize("case", MOVES + [
    ((4096, 1024), {"dp": 2, "mp": 2}, ["mp", None], {"x": 4}, ["x", None])])
@pytest.mark.parametrize("order", ["same", "reversed"])
def test_plans_match_the_jax_planner(case, order):
    shape, sa, ss, da, ds = case
    W = int(np.prod(list(sa.values())))
    Wd = int(np.prod(list(da.values())))
    dmap = None if order == "same" else tuple(
        list(range(Wd))[::-1] + list(range(Wd, W)))
    for itemsize, dtype in ((4, "float32"), (2, "bfloat16")):
        want = jplanner.plan_reshard(shape, itemsize,
                                     *_specs(jspec, shape, sa, ss, da, ds),
                                     dst_device_map=dmap, dtype=dtype)
        got = rs.plan_reshard(shape, itemsize,
                              *_specs(rs, shape, sa, ss, da, ds),
                              dst_device_map=dmap, dtype=dtype)
        assert rs.plan_as_dict(got) == jplanner.plan_as_dict(want)
        assert rs.plan_sends(got) == jplanner.plan_sends(want)
        assert rs.describe(got) == jplanner.describe(want)
        assert [s.perm for s in got.steps] == [s.perm for s in want.steps]


@pytest.mark.parametrize("case", [
    ((6, 6), {"a": 2, "b": 3}, ["a", "b"], {"c": 3, "d": 2}, ["c", "d"],
     None),
    ((8,), {"a": 2}, ["a"], {"b": 4}, ["b"], None),
    ((6,), {"a": 4}, ["a"], {"b": 4}, [None], None),
    ((8,), {"a": 4}, ["a"], {"b": 4}, ["b"], (0, 0, 1, 2)),
])
def test_unplannable_as_the_jax_planner(case):
    shape, sa, ss, da, ds, dmap = case
    with pytest.raises(jspec.Unplannable) as want:
        jplanner.plan_reshard(shape, 4, *_specs(jspec, shape, sa, ss, da, ds),
                              dst_device_map=dmap)
    with pytest.raises(rs.Unplannable) as got:
        rs.plan_reshard(shape, 4, *_specs(rs, shape, sa, ss, da, ds),
                        dst_device_map=dmap)
    head = [str(e.value).split(" — ")[0] for e in (got, want)]
    assert head[0] == head[1], head


def test_plan_for_segments_and_device_orders():
    """A segmented dimension plans segment by segment where the other side
    holds it whole or in the same segments, and is Unplannable against a
    contiguous split of it; a reversed destination mesh ends in the
    device-order ppermute."""
    two = DeviceMesh([0, 1], ("mp",))
    seg = NamedSharding(two, TP(None, "mp"), segments={1: (8, 4, 4)})
    x = rs.ShardedTensor(torch.zeros(4, 8), seg)
    assert x.shape == (4, 16)
    rows = NamedSharding(DeviceMesh([0, 1], ("s",)), TP("s", None))
    plan = rs.plan_for(x, rows)
    assert isinstance(plan, rs.SegmentedPlan) and len(plan.plans) == 3
    assert [p.global_shape for p in plan.plans] == [(4, 8), (4, 4), (4, 4)]
    with pytest.raises(rs.Unplannable, match="contiguous"):
        rs.plan_for(x, NamedSharding(DeviceMesh([0, 1], ("s",)),
                                     TP(None, "s")))
    back = NamedSharding(DeviceMesh([1, 0], ("y",)), TP("y", None))
    plan = rs.plan_for(rs.ShardedTensor(torch.zeros(2, 16), rows), back)
    assert [s.op for s in plan.steps] == ["ppermute"]


# ---------------- the executor on gloo ranks -------------------------------
def _assert_moves(outs, cases):
    for name in cases:
        hops = [o[name] for o in outs]
        for i in range(len(hops[0])):
            rows = [h[i] for h in hops if i < len(h)]
            assert all(r["equal"] for r in rows), (name, i)
            got = sum(r["received"] for r in rows)
            assert got == rows[0]["wire"], (name, i, got, rows[0]["wire"])
            plan = rows[0]["plan"]
            assembled = isinstance(plan, str)
            assert all(r["assembled"] == int(assembled) for r in rows), \
                (name, i)
            if isinstance(plan, dict):
                assert plan["bytes_wire"] == rows[0]["wire"]
    return outs


def test_executor_on_two_and_four_ranks(tmp_path):
    two, four = tmp_path / "two", tmp_path / "four"
    for d, cases in ((two, TWO), (four, FOUR)):
        d.mkdir()
        torch.save({"cases": cases}, d / "inputs.pt")
    with R.Ranks("reshard", two) as r2, R.Ranks("reshard", four,
                                                world=4) as r4:
        outs2, outs4 = r2.results(), r4.results()
    _assert_moves(outs2, TWO)
    _assert_moves(outs4, FOUR)
    # what the cases were there to show
    plan = outs2[0]["segments"][0]["plan"]
    assert isinstance(plan, list) and len(plan) == 3
    assert outs2[0]["segments_to_contiguous"][0]["assembled"] == 1
    assert outs2[0]["permutation"][0]["plan"]["steps"][-1]["op"] \
        == "ppermute"
    assert outs2[0]["int64_identity"][0]["plan"]["steps"] == []
    assert len(outs4[0]["chain"]) == 2 and len(outs4[1]["chain"]) == 2
    for name in FOUR:
        if name.startswith("zoo"):
            shape, (src, dst) = FOUR[name][0], FOUR[name][2]
            want = jplanner.plan_reshard(
                shape, 4, *_specs(jspec, shape, *src, *dst), dtype="float32")
            assert outs4[0][name][0]["plan"] == jplanner.plan_as_dict(want)


# ---------------- the checkpoint onto another layout ------------------------
def _jax_sharding(spec, devices):
    axes, entries, _ = spec
    mesh = Mesh(np.array(devices[:int(np.prod(list(axes.values())))])
                .reshape(tuple(axes.values())), tuple(axes))
    return JNamedSharding(mesh, P(*[tuple(e) if isinstance(e, list) else e
                                    for e in entries]))


def _jax_blocks(directory, specs):
    """The JAX ``load_tree(shardings=)`` of ``specs`` (the port's
    placements as data): per leaf, each device's block, by rank."""
    devices = jax.devices()
    shardings = {part: {n: (_jax_sharding(s, devices) if isinstance(s, tuple)
                            else {k: _jax_sharding(v, devices)
                                  for k, v in s.items()})
                        for n, s in specs[part].items()}
                 for part in ("params", "opt_state")}
    tree = jckpt.CheckpointManager(directory).restore(shardings=shardings)
    pos = {d: i for i, d in enumerate(devices)}

    def blocks(a):
        if not isinstance(a, jax.Array):  # a host leaf: whole everywhere
            return {i: np.asarray(a) for i in range(len(devices))}
        return {pos[s.device]: np.asarray(s.data)
                for s in a.addressable_shards}

    return {part: {n: blocks(v) if not isinstance(v, dict)
                   else {k: blocks(w) for k, w in v.items()}
                   for n, v in tree[part].items()}
            for part in ("params", "opt_state")}


def _leaves(tree, specs):
    """``(path, leaf, spec)`` of every tensor leaf of params/opt_state."""
    for part in ("params", "opt_state"):
        for n, v in tree[part].items():
            if isinstance(v, dict):
                for k, w in v.items():
                    yield (part, n, k), w, specs[part][n][k]
            else:
                yield (part, n), v, specs[part][n]


def _pick(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_restore_onto_another_layout(tmp_path):
    jm, params = _jax_model()
    xs = np.random.default_rng(21).integers(0, 128, (4, 4, 32))
    ys = np.roll(xs, -1, axis=2)
    torch.save({"params": _torch_tree(params), "x": torch.from_numpy(xs),
                "y": torch.from_numpy(ys)}, tmp_path / "inputs.pt")
    with R.Ranks("reshard_ckpt", tmp_path) as ranks:
        jstep = _jax_step(_mesh((2, 2), ("dp", "mp")))
        for k in range(2):
            jstep(xs[k], ys[k])
        mgr = jckpt.CheckpointManager(str(tmp_path / "jax_ck"))
        mgr.save(2, jstep.state_for_checkpoint().to_tree())
        mgr.wait_until_finished()
        (tmp_path / "jax_ck.ready").touch()
        outs = ranks.results()
    port_ck = str(tmp_path / "port_ck")
    specs = outs[0]["shardings"]
    want = _jax_blocks(port_ck, specs)
    saved = jckpt.CheckpointManager(port_ck).restore()
    with open(os.path.join(port_ck, "step_00000002", "manifest.json")) as f:
        written = json.load(f)["bytes_written"]
    for r, out in enumerate(outs):
        assert out["shardings"] == specs
        # a split leaf comes back as a ShardedTensor of its placement
        assert out["placed"] and out["live_placed"]
        total = 0
        for path, leaf, spec in _leaves(out["blocks"], specs):
            ref = _pick(want, path)[r]
            assert _bits(leaf) == _bits(ref), path
            assert _bits(_pick(out["checked"], path)) == _bits(leaf), path
            assert _bits(_pick(out["live"], path)) == _bits(leaf), path
            for key in ("handed_over", "cross"):
                assert _bits(_pick(out[key], path)) == _bits(
                    _pick(saved, path)), (key, path)
            total += leaf.numel() * leaf.element_size()
        # without validation each rank read its blocks' bytes and nothing
        # else; with it, every file its blocks overlap whole (here every
        # file: the port saves each array whole)
        assert out["read"]["bytes"] == total, (out["read"], total)
        assert out["checked_read"]["bytes"] == written, (
            out["checked_read"], written)
        assert out["refuse_plain"].startswith("ValueError") \
            and "ShardedTensor" in out["refuse_plain"], out["refuse_plain"]
        # the live restore: every sharded leaf moved device to device, the
        # ranks' received bytes the plans' bytes_wire
        st = out["live_stats"]
        assert st["plans"] == out["live_read"]["live"] > 0
        assert st["assembled"] == 0
    assert sum(o["live_stats"]["bytes_received"] for o in outs) \
        == outs[0]["live_stats"]["bytes_wire"] > 0
    # the run continued on the new layout, against the JAX step continued
    # from the same save on the same mesh
    _reset_jax_world()
    jz = _jax_step(_mesh((2,), ("sharding",)), level="p_g_os")
    jz.restore_from_checkpoint(jckpt.CheckpointManager(port_ck).restore(
        shardings=jz.checkpoint_shardings()))
    jl = [float(jz(xs[k], ys[k])) for k in range(2, 4)]
    for out in outs:
        assert np.abs(np.array(out["continued"]) - jl).max() <= LOSS_TOL, (
            out["continued"], jl)
    # the JAX package's (2, 2)-mesh save onto the port's mp-2 placements:
    # the JAX load_tree blocks, and the qkv's segments of its whole array
    mp_specs = outs[0]["mp_shardings"]
    jdir = str(tmp_path / "jax_ck")
    whole = jckpt.CheckpointManager(jdir).restore()
    plain = {part: {n: ({k: v for k, v in s.items()
                         if not v[2]} if isinstance(s, dict) else s)
                    for n, s in mp_specs[part].items()
                    if isinstance(s, dict) or not s[2]}
             for part in ("params", "opt_state")}
    jwant = _jax_blocks(jdir, plain)
    for r, out in enumerate(outs):
        total = 0
        for path, leaf, spec in _leaves(out["jax_blocks"], mp_specs):
            if spec[2]:
                (d, sizes), = spec[2].items()
                ref = local_block(torch.from_numpy(np.asarray(
                    _pick(whole, path))), d, r, 2, sizes)
            else:
                ref = _pick(jwant, path)[r]
            assert _bits(leaf) == _bits(ref), path
            total += leaf.numel() * leaf.element_size()
        assert out["jax_read"]["bytes"] == total, (out["jax_read"], total)
    # the JAX save wrote a leaf split over the mp axis as several shards
    with open(os.path.join(jdir, "step_00000002", "manifest.json")) as f:
        shards = [len(e["shards"]) for e in json.load(f)["arrays"].values()]
    assert max(shards) == 2
