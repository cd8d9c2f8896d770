"""The port's input pipeline (``paddle_tpu_torch.data``, ``io.prefetch``)
against the JAX package's, on the CPU.

Shard files are written into ``tmp_path`` from a seed. Over the same files
and seed every source, the packer and ``build_pretrain_pipeline`` yield
the JAX package's records and batches bit for bit (the shuffles are numpy
seeded by ``mix_seed``, which agrees integer for integer); a mid-epoch
state resumes at the same batch, the feeder's state after batch k resumes
at k+1 whatever the prefetch depth, and an early ``break`` leaves no
thread behind.
"""

import json
import threading

import numpy as np
import pytest
import torch

from paddle_tpu import data as jdata
from paddle_tpu_torch import data as tdata
from paddle_tpu_torch.checkpoint import CheckpointManager, TrainState
from paddle_tpu_torch.io import DevicePrefetcher, prefetch_to_device

EOS = 1


def _token_shards(tmp_path, n_shards=4, docs=25, lo=6, hi=40, seed=0):
    """uint16 token shards of eos-ended documents of random length."""
    rng = np.random.RandomState(seed)
    paths = []
    for s in range(n_shards):
        parts = []
        for _ in range(docs):
            d = rng.randint(2, 1000, size=rng.randint(lo, hi)) \
                .astype(np.uint16)
            d[-1] = EOS
            parts.append(d)
        p = tmp_path / f"shard_{s:02d}.bin"
        np.concatenate(parts).tofile(p)
        paths.append(str(p))
    return paths


def _jsonl_shards(tmp_path, seed=1):
    rng = np.random.RandomState(seed)
    paths = []
    for s in range(3):
        p = tmp_path / f"part_{s}.jsonl"
        with open(p, "w") as f:
            for i in range(12):
                if i % 3:
                    toks = rng.randint(0, 500, rng.randint(3, 30)).tolist()
                    f.write(json.dumps({"tokens": toks}) + "\n")
                else:
                    f.write(json.dumps({"text": f"doc {s}.{i} é"}) + "\n")
        paths.append(str(p))
    return paths


def _text_shards(tmp_path):
    paths = []
    for s in range(3):
        p = tmp_path / f"lines_{s}.txt"
        p.write_text("".join(f"line {s}-{i}\n\n" for i in range(9)))
        paths.append(str(p))
    return paths


def _take(it, n):
    return [next(it) for _ in range(n)]


def _same(a, b):
    """Records or batches equal bit for bit (numpy or tensors)."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, str):
        assert a == b
    else:
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_mix_seed_agrees():
    table = [(0,), (1,), (7, 0), (7, 1), (2 ** 40, 3, 5),
             (123456789, 9, 17, 1), (0, 0, 0, 0), (-1,), (2 ** 64 + 5, 2)]
    for parts in table:
        assert tdata.mix_seed(*parts) == jdata.mix_seed(*parts), parts


def test_shard_assignment_and_coverage_agree(tmp_path):
    files = [f"f{i:03d}.bin" for i in range(23)]
    for count in (1, 3, 4):
        for epoch in (0, 1, 5):
            for shuffle in (True, False):
                for idx in range(count):
                    assert tdata.shard_assignment(
                        files, idx, count, seed=9, epoch=epoch,
                        shuffle=shuffle) == jdata.shard_assignment(
                        files, idx, count, seed=9, epoch=epoch,
                        shuffle=shuffle)
                assert tdata.validate_coverage(files, count, seed=9,
                                               epoch=epoch) == \
                    jdata.validate_coverage(files, count, seed=9,
                                            epoch=epoch)
    (tmp_path / "b.bin").write_bytes(b"")
    (tmp_path / "a.bin").write_bytes(b"")
    pat = str(tmp_path / "*.bin")
    assert tdata.expand_files(pat) == jdata.expand_files(pat)
    assert tdata.expand_files([str(tmp_path / "b.bin"), pat], sort=False) \
        == jdata.expand_files([str(tmp_path / "b.bin"), pat], sort=False)
    with pytest.raises(tdata.CoverageError):
        import paddle_tpu_torch.data.sources as tsrc

        real = tsrc.shard_assignment
        try:
            tsrc.shard_assignment = lambda f, i, c, **k: list(f)
            tdata.validate_coverage(files, 2)
        finally:
            tsrc.shard_assignment = real


SOURCES = {
    "bin_eos": (_token_shards, "TokenBinSource",
                dict(eos_id=EOS, shuffle_records=True)),
    "bin_chunks": (_token_shards, "TokenBinSource",
                   dict(chunk_len=16, dtype="uint16")),
    "jsonl": (_jsonl_shards, "JsonlSource", dict(shuffle_records=True)),
    "text": (_text_shards, "TextLineSource", dict(shuffle_shards=False)),
}


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_source_yields_the_reference_records(tmp_path, name):
    """Two epochs of records (the epoch-seeded reshuffles), for process 1
    of 2 and its state after each record, then a mid-epoch resume."""
    write, cls, kw = SOURCES[name]
    paths = write(tmp_path)
    mk = {m: lambda m=m: getattr(m, cls)(paths, seed=3, process_index=1,
                                         process_count=2, **kw)
          for m in (jdata, tdata)}
    js, ts = mk[jdata](), mk[tdata]()
    n = 0
    for _ in range(2 * sum(1 for _ in mk[jdata]().local_shards()) * 40):
        try:
            a = next(js)
        except StopIteration:
            break
        _same(a, next(ts))
        assert js.get_state() == ts.get_state()
        n += 1
        if ts.epoch == 2:
            break
    assert n > 10 and ts.epoch >= 1
    state = json.loads(json.dumps(ts.get_state()))
    resumed = mk[tdata]()
    resumed.set_state(state)
    for _ in range(15):
        _same(next(js), next(resumed))


@pytest.mark.parametrize("split", [False, True], ids=["truncate", "split"])
def test_packer_yields_the_reference_batches(tmp_path, split):
    """Tokens, segment ids and positions bit for bit (documents longer
    than S truncated or split), and the carry state after every batch."""
    paths = _token_shards(tmp_path, lo=4, hi=70)
    packers = [m.SequencePacker(m.TokenBinSource(paths, eos_id=EOS, seed=2,
                                                 process_index=0,
                                                 process_count=1),
                                3, 48, split_long_docs=split)
               for m in (jdata, tdata)]
    for _ in range(12):
        _same(next(packers[0]), next(packers[1]))
        assert packers[0].get_state() == packers[1].get_state()
    assert packers[0].efficiency == packers[1].efficiency
    assert packers[0].docs_truncated == packers[1].docs_truncated


def _pipelines(paths, **kw):
    args = dict(eos_id=EOS, seed=4, process_index=0, process_count=1,
                shuffle_records=True)
    args.update(kw)
    return (jdata.build_pretrain_pipeline(paths, 2, 24, device_feed=False,
                                          **args),
            tdata.build_pretrain_pipeline(paths, 2, 24, device="cpu",
                                          **args))


def test_pipeline_yields_the_reference_batches(tmp_path):
    """``build_pretrain_pipeline``: the JAX package's host batches against
    the port's batches, which its feeder yields as CPU int32 tensors."""
    j, t = _pipelines(_token_shards(tmp_path))
    ji, ti = iter(j), iter(t)
    for _ in range(20):
        a, b = next(ji), next(ti)
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
                   and v.dtype == torch.int32 for v in b.values())
        _same(a, b)
    ti.close()
    # the feeder's snapshot is taken on the producer's thread, so its
    # "batches" count is the consumer's count at that moment (timing
    # dependent, in the JAX package's feeder too); the stages' positions
    # are exact
    got, want = t.get_state(), j.get_state()
    assert (got["source"], got["packer"]) == (want["source"], want["packer"])


def test_pipeline_midepoch_resume(tmp_path):
    """The state after batch k, through ``TrainState.data_position`` and a
    ``CheckpointManager`` step, resumes a new pipeline at batch k+1."""
    paths = _token_shards(tmp_path)
    _, t = _pipelines(paths)
    it = iter(t)
    _take(it, 7)
    mgr = CheckpointManager(str(tmp_path / "ck"), async_=False)
    mgr.save(7, TrainState(params={}, opt_state={}, step=7,
                           data_position=t.get_state()).to_tree())
    want = _take(it, 9)
    it.close()
    _, t2 = _pipelines(paths)
    t2.set_state(TrainState.from_tree(mgr.restore()).data_position)
    it2 = iter(t2)
    for a, b in zip(want, _take(it2, 9)):
        _same(a, b)
    it2.close()
    mgr.close()


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_feeder_state_resumes_after_the_consumed_batch(tmp_path, depth):
    """Whatever the prefetch depth (how far the producer runs ahead), the
    state read after batch k resumes at batch k+1; ``host_wait_ms_mean``
    is kept."""
    paths = _token_shards(tmp_path)

    def build():
        return tdata.build_pretrain_pipeline(
            paths, 2, 24, eos_id=EOS, seed=4, process_index=0,
            process_count=1, prefetch_depth=depth, device="cpu")

    pipe = build()
    it = iter(pipe)
    _take(it, 5)
    state = json.loads(json.dumps(pipe.get_state()))
    want = _take(it, 6)
    assert pipe.host_wait_ms_mean >= 0.0 and pipe.feeder.batches_fed == 11
    it.close()
    again = build()
    again.set_state(state)
    it2 = iter(again)
    for a, b in zip(want, _take(it2, 6)):
        _same(a, b)
    it2.close()


def test_early_break_leaves_no_thread(tmp_path):
    paths = _token_shards(tmp_path)
    before = set(threading.enumerate())
    for depth in (1, 3):
        pipe = tdata.build_pretrain_pipeline(
            paths, 2, 24, eos_id=EOS, seed=4, process_index=0,
            process_count=1, prefetch_depth=depth, device="cpu")
        for i, _ in enumerate(pipe):
            if i == 2:
                break
        for _ in prefetch_to_device(iter(range(100)), depth=depth,
                                    device="cpu"):
            break
    import gc
    import time

    gc.collect()  # close the abandoned generators
    deadline = time.time() + 5
    while time.time() < deadline and set(threading.enumerate()) - before:
        time.sleep(0.05)
    assert not [t.name for t in set(threading.enumerate()) - before]


def test_prefetcher_passes_trees_and_errors(tmp_path):
    """Nested batches come back as tensors (scalars kept), in order; an
    exception in the upstream reaches the consumer."""
    batches = [{"x": np.full((2, 3), i, np.int32), "meta": [i, "s"]}
               for i in range(5)]
    got = list(DevicePrefetcher(batches, depth=2, device="cpu"))
    assert [int(b["x"][0, 0]) for b in got] == list(range(5))
    assert got[3]["meta"] == [3, "s"] and got[0]["x"].dtype == torch.int32

    def bad():
        yield {"x": np.zeros(2)}
        raise ValueError("upstream broke")

    with pytest.raises(ValueError, match="upstream broke"):
        list(DevicePrefetcher(bad(), device="cpu"))


def test_unported_options_raise(tmp_path):
    """A batch split along its sequence (context parallelism) raises
    naming A5.7; ``batch_sharding`` checks its axes as the JAX package's
    does, and ``mesh=`` records the batch's placement."""
    from paddle_tpu_torch.distributed import (DeviceMesh, NamedSharding,
                                              PartitionSpec)

    paths = _token_shards(tmp_path)
    mesh = DeviceMesh([0], ("dp",))
    with pytest.raises(ValueError, match="no axes"):
        tdata.batch_sharding(mesh, ("dp", "sharding"))
    assert tdata.batch_sharding(mesh).spec == PartitionSpec(("dp",))
    pipe = tdata.build_pretrain_pipeline(paths, 2, 24, eos_id=EOS,
                                         mesh=mesh, device="cpu")
    assert pipe.feeder.sharding == tdata.batch_sharding(mesh)
    with pytest.raises(NotImplementedError, match="A5.7"):
        tdata.GlobalBatchFeeder(iter([]), device="cpu", sharding=(
            NamedSharding(mesh, PartitionSpec("dp", "dp"))))
