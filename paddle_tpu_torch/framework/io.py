"""save/load and auto-checkpointing (``paddle_tpu/framework/io.py``
analog).

``save``/``load`` keep the JAX package's pickle container: ``{"magic":
"paddle_tpu.checkpoint.v1", "obj": payload}``, with each tensor stored as
``{"__tensor__": True, "data": numpy, "trainable": bool}`` inside nested
dicts, lists and tuples. ``load`` gives tensors back as CPU torch tensors
(numpy with ``return_numpy=True``). Across the two packages this pickle
holds fp32, int and bool tensors: the JAX package pickles bf16 as
``ml_dtypes`` arrays, which cannot be unpickled without ``ml_dtypes``, so
the port writes a bf16 tensor as its raw 2-byte words (``data`` uint16)
with ``"dtype": "bfloat16"`` beside them, and reads that back bitwise
itself; the cross-package path for bf16 is the sharded format
(``save_sharded``/``load_sharded``, over ``paddle_tpu_torch.checkpoint``).

``save_async``/``wait_async_saves`` write in the background after a host
snapshot, and a failed write is re-raised. ``enable_auto_checkpoint``
installs a SIGTERM save (a path with an extension is one pickle file,
one without a ``CheckpointManager`` directory) and, with
``every_n_steps``, a periodic save through ``auto_checkpoint_step()``.
"""

from __future__ import annotations

import os
import pickle
import threading

import numpy as np
import torch

from ..weights import to_torch

_SAVE_MAGIC = "paddle_tpu.checkpoint.v1"


def _to_payload(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        out = {"__tensor__": True, "trainable":
               isinstance(obj, torch.nn.Parameter) and obj.requires_grad}
        if t.dtype == torch.bfloat16:
            out.update(data=t.contiguous().view(torch.uint16).numpy().copy(),
                       dtype="bfloat16")
        else:
            out["data"] = t.numpy().copy()
        return out
    if isinstance(obj, dict):
        return {k: _to_payload(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_payload(v) for v in obj)
    return obj


def _from_payload(obj, return_numpy=False):
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            data = obj["data"]
            if obj.get("dtype") == "bfloat16":
                t = torch.from_numpy(np.ascontiguousarray(data)).view(
                    torch.bfloat16)
                return t if not return_numpy else data
            return data if return_numpy else to_torch(np.asarray(data))
        return {k: _from_payload(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_payload(v, return_numpy) for v in obj)
    return obj


def save(obj, path: str, protocol: int = 4, **configs):
    """paddle.save: pickle ``obj`` (a state dict or nested container)."""
    if isinstance(path, str):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
    payload = {"magic": _SAVE_MAGIC, "obj": _to_payload(obj)}
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=protocol)


def load(path: str, return_numpy: bool = False, **configs):
    """paddle.load: a saved object back, tensors as CPU tensors (or
    numpy; a bf16 tensor as its uint16 words with ``return_numpy``)."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if isinstance(payload, dict) and payload.get("magic") == _SAVE_MAGIC:
        return _from_payload(payload["obj"], return_numpy)
    return _from_payload(payload, return_numpy)  # a foreign pickle


# ---- async saves ----
_async_threads = []
_async_errors = []
_async_lock = threading.Lock()
_async_seq = 0  # monotonic: tmp names stay unique after reaping


def _reap_async_threads():
    """Drop finished threads, so the list holds the in-flight saves."""
    with _async_lock:
        _async_threads[:] = [t for t in _async_threads if t.is_alive()]


def save_async(obj, path: str):
    """Non-blocking save: the host snapshot now, the write on a thread.
    Concurrent saves to one path are safe (each writes its own tmp file
    and publishes it by rename). A failed write is re-raised by the next
    ``wait_async_saves()``."""
    global _async_seq
    _reap_async_threads()
    payload = {"magic": _SAVE_MAGIC, "obj": _to_payload(obj)}  # host copy
    with _async_lock:
        _async_seq += 1
        seq = _async_seq
    tmp = f"{path}.tmp.{os.getpid()}.{seq}"

    def _write():
        try:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(tmp, "wb") as f:
                pickle.dump(payload, f, protocol=4)
            os.replace(tmp, path)  # atomic publish
        except BaseException as e:  # noqa: BLE001 — wait_async_saves raises
            with _async_lock:
                _async_errors.append(e)

    t = threading.Thread(target=_write, daemon=True)
    t.start()
    with _async_lock:
        _async_threads.append(t)
    return t


def wait_async_saves():
    """Join every in-flight ``save_async``; if any failed since the last
    call, raise ``AsyncCheckpointError`` (the first failure chained)."""
    while True:
        with _async_lock:
            if not _async_threads:
                break
            t = _async_threads.pop()
        t.join()
    with _async_lock:
        errs, _async_errors[:] = list(_async_errors), []
    if errs:
        from ..checkpoint.async_writer import AsyncCheckpointError

        raise AsyncCheckpointError(
            f"{len(errs)} background save(s) failed; first: {errs[0]!r}"
        ) from errs[0]


def save_sharded(state: dict, directory: str):
    """The JAX package's sharded format (a manifest and one file per
    shard, CRC32-checked), through ``checkpoint.save_tree``; no step
    management (``CheckpointManager`` has it). A ``ShardedTensor`` leaf
    (a train step's ``state_for_checkpoint()`` over mp, ZeRO or ep) is
    written as its blocks, each by its replica-0 rank, and a whole array
    by rank 0. Across ranks every rank calls it: each writes its files
    and its manifest part, and after a barrier rank 0 merges the parts
    into the manifest; a last barrier ends the save on every rank. No
    array is gathered."""
    from ..checkpoint import arrays as _ckpt_arrays
    from ..distributed.communication import barrier

    path = os.path.abspath(directory)
    rank, world = _ckpt_arrays._world()
    if world == 1:
        _ckpt_arrays.save_tree(path, dict(state))
        return
    _ckpt_arrays.save_tree(path, dict(state),
                           manifest_name=f"manifest.part{rank}.json")
    barrier()
    if rank == 0:
        parts = [f"manifest.part{p}.json" for p in range(world)]
        _ckpt_arrays.write_manifest(path, _ckpt_arrays.merge_manifests(
            [_ckpt_arrays.read_manifest(path, name) for name in parts]))
        for name in parts:
            os.remove(os.path.join(path, name))
    barrier()


def load_sharded(directory: str, shardings: dict = None) -> dict:
    """``save_sharded``'s (or the JAX package's) arrays back as CPU
    tensors: whole, or where ``shardings`` (a ``NamedSharding`` per array)
    splits one, this rank's block of it as a ``ShardedTensor``, read from
    the shard files it overlaps, each CRC-checked."""
    from ..checkpoint import arrays as _ckpt_arrays

    return _ckpt_arrays.load_tree(os.path.abspath(directory),
                                  shardings=shardings or None)


# ---- auto-checkpoint on SIGTERM and every N steps ----
_auto_ckpt_state = {}


def enable_auto_checkpoint(path: str, state_fn=None, layer=None,
                           optimizer=None, every_n_steps: int = 0,
                           keep_last_n: int = None, data_loader=None,
                           sigterm_deadline_s: float = None):
    """Install a SIGTERM handler that saves the training state before the
    process dies, and with ``every_n_steps`` a periodic save through
    ``auto_checkpoint_step()``.

    The state is ``state_fn()``, else ``{"model": layer.state_dict(),
    "optimizer": optimizer.state_dict(), "data_position": ...}`` from what
    is given. A ``path`` with a file extension is one pickle file
    (``save``); without one it is a ``CheckpointManager`` directory
    (step directories, atomic COMMIT, ``keep_last_n``). With
    ``sigterm_deadline_s`` the SIGTERM save runs on a thread and is
    abandoned after that many seconds (an uncommitted step stays
    invisible to restore); without it the save runs to completion."""
    import signal

    def collect():
        if state_fn is not None:
            return state_fn()
        state = {}
        if layer is not None:
            state["model"] = layer.state_dict()
        if optimizer is not None and hasattr(optimizer, "state_dict"):
            state["optimizer"] = optimizer.state_dict()
        if data_loader is not None:
            from ..data.protocol import iterator_state

            pos = iterator_state(data_loader)
            if pos is not None:
                state["data_position"] = pos
        return state

    mgr = None
    if os.path.splitext(path)[1] == "":  # a directory: managed steps
        from ..checkpoint import CheckpointManager

        mgr = CheckpointManager(path, keep_last_n=keep_last_n, async_=True)

    def publish_final():
        if mgr is not None:
            mgr.save(_auto_ckpt_state.get("step", 0), collect(), force=True)
            mgr.wait_until_finished()
        else:
            wait_async_saves()  # in-flight periodic saves publish first
            save(collect(), path)

    def on_sigterm(signum, frame):
        if sigterm_deadline_s is None:
            publish_final()
        else:
            done = threading.Event()

            def worker():
                try:
                    publish_final()
                finally:
                    done.set()

            threading.Thread(target=worker, daemon=True,
                             name="sigterm-ckpt").start()
            done.wait(float(sigterm_deadline_s))
        prev = _auto_ckpt_state.get("prev_handler")
        if callable(prev):
            prev(signum, frame)
        raise SystemExit(143)

    _auto_ckpt_state.update(
        path=path, collect=collect, every=every_n_steps, step=0,
        manager=mgr, prev_handler=signal.getsignal(signal.SIGTERM),
    )
    signal.signal(signal.SIGTERM, on_sigterm)
    return mgr


def auto_checkpoint_step():
    """Call once per training step: saves asynchronously every N steps when
    ``enable_auto_checkpoint(..., every_n_steps=N)`` is active."""
    st = _auto_ckpt_state
    if not st or not st.get("every"):
        return
    st["step"] += 1
    if st["step"] % st["every"] == 0:
        mgr = st.get("manager")
        if mgr is not None:
            # the manager's ordered writer queues the write; this call
            # blocks for the host snapshot only
            mgr.save(st["step"], st["collect"](), force=True)
            return
        # don't stack saves: skip while the previous one is in flight
        prev = st.get("inflight")
        if prev is not None and prev.is_alive():
            return
        st["inflight"] = save_async(st["collect"](), st["path"])


def disable_auto_checkpoint():
    import signal

    if _auto_ckpt_state:
        prev = _auto_ckpt_state.get("prev_handler")
        signal.signal(signal.SIGTERM,
                      prev if prev is not None else signal.SIG_DFL)
        mgr = _auto_ckpt_state.get("manager")
        if mgr is not None:
            mgr.close()
        _auto_ckpt_state.clear()
