"""Serving a split model (ROADMAP A5.5b) against the JAX package, on the
CPU: the port's engine on a model split over gloo ranks gives the JAX
engine's greedy tokens, the JAX engine's weights relaid by
``load_weights(shardings=)`` onto the matching mesh, and every rank gives
the same tokens.

The port's ranks run as gloo processes (``Ranks``, the ``split_*`` jobs of
``tests/torch_dist_jobs.py``, at most 60 s) while the JAX reference
computes on ``tests/conftest.py``'s CPU devices, on the same weights
(random, std 0.2, so greedy decoding does not collapse onto one token):

- the tiny GPT (GQA 4/2) at mp 2, the tiny GPT-MoE (4 experts, the MoE
  FFN in block 1) at ep 2 and at ep 2 x mp 2, each through the paged
  engine, the dense one and the paged one with the prefix cache and
  speculation (2 slots, 64 positions, five prompts sharing a 16-token
  prefix), and through ``generate``;
- sampled requests, and a sampled ``generate`` under generators seeded
  alike: equal on every rank (the logits are whole and bitwise equal on
  every rank, the engines' generators seeded alike);
- at mp 2, ``load_weights`` from a live ZeRO-3 step at sharding 2 (device
  to device through the resharding executor: the bytes received equal to
  the plans' ``bytes_wire``) and from that step's sharded save, each
  giving the tokens of the same weights loaded whole; a placement the
  built model does not hold is refused.

Greedy tokens are compared exactly: the port's fp32 logits agree with the
JAX engine's to summation order (1e-4, ``test_torch_serving_spec``), and
these weights leave no argmax that close.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu.core.autograd import no_grad
from paddle_tpu.distributed.fleet.utils import param_shardings
from paddle_tpu.models.gpt import gpt_tiny
from paddle_tpu.serving import Engine as JEngine
from paddle_tpu.serving import EngineConfig as JEngineConfig
from paddle_tpu.serving import SamplingParams as JSamplingParams

from paddle_tpu_torch.distributed.sharding_utils import local_block

import test_torch_dist_ranks as R
import torch_dist_jobs as J
from test_torch_distributed import _reset_jax_world
from test_torch_moe import _jax_model as _moe_jax_model
from test_torch_serving_spec import _random_params, _shared_prefix_prompts

#: the prompts' seed: a 16-token shared prefix, two with repeated phrases
PROMPT_SEED = 7
#: ``generate``'s batch
GEN_IDS = np.array([[5, 17, 3, 9], [9, 2, 11, 4]], np.int64)


@pytest.fixture(autouse=True)
def _fresh_jax_world():
    _reset_jax_world()
    yield
    _reset_jax_world()


def _dense_jax():
    paddle.seed(0)
    jm = gpt_tiny(dropout=0.0, num_kv_heads=2)
    jm.eval()
    params = _random_params(jm, 0)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in params.items()})
    return jm, params


def _mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _jax_tokens(jm, mesh, prompts):
    """The JAX engine's greedy tokens through each of ``J.ENGINES``, its
    weights relaid onto ``mesh`` by ``load_weights(shardings=)`` at each
    parameter's ``dist_spec``; and its ``generate`` of ``GEN_IDS``."""
    out = {}
    params = jm.functional_state()[0]
    for name, kw in J.ENGINES.items():
        eng = JEngine(jm, JEngineConfig(max_batch_size=2, max_seq_len=64,
                                        **kw))
        eng.load_weights(params, shardings=param_shardings(jm, mesh))
        out[name] = eng.generate(prompts, JSamplingParams(max_new_tokens=8))
    with no_grad():
        out["generate"] = np.asarray(jm.generate(
            paddle.to_tensor(GEN_IDS), max_new_tokens=8).numpy())
    return out


def _inputs(tmp_path, prompts, **extra):
    torch.save({"prompts": prompts, "gen_ids": torch.from_numpy(GEN_IDS),
                **extra}, tmp_path / "inputs.pt")


def _assert_served(outs, key, want):
    """Every rank's engines and ``generate`` against the JAX tokens, and
    the ranks against each other: tokens, finishes, slot and page tables,
    speculation counters; the sampled requests and ``generate`` equal on
    every rank. A split model over gloo serves eagerly."""
    first = outs[0][key]
    for out in outs:
        got = out[key]
        for name in J.ENGINES:
            run = got[name]
            assert run["tokens"] == want[name], (key, name, run["tokens"],
                                                 want[name])
            assert not run["captured"] and run["eager_steps"] > 0
            for field in ("finish", "hits", "slots", "spec"):
                assert run[field] == first[name][field], (key, name, field)
            if run["pages"] is not None:
                assert torch.equal(run["pages"], first[name]["pages"])
        assert got["spec"]["spec"][1] > 0  # drafts were accepted
        assert got["spec"]["hits"] != [0] * len(got["spec"]["hits"])
        assert np.array_equal(got["generate"].numpy(), want["generate"])
        assert got["sampled"]["tokens"] == first["sampled"]["tokens"]
        assert got["sampled"]["slots"] == first["sampled"]["slots"]
        assert torch.equal(got["generate_sampled"],
                           first["generate_sampled"])
    # sampling drew: not the greedy stream
    assert first["sampled"]["tokens"] != first["paged"]["tokens"]


def test_split_serving_at_mp2(tmp_path):
    jm, params = _dense_jax()
    params2 = _random_params(jm, 1)
    prompts = _shared_prefix_prompts(PROMPT_SEED)
    xs = np.random.default_rng(3).integers(0, 128, (1, 4, 16))
    _inputs(tmp_path, prompts,
            params={k: torch.from_numpy(v) for k, v in params.items()},
            params2=J.from_paddle_tpu(params2),
            x=torch.from_numpy(xs), y=torch.from_numpy(np.roll(xs, -1, 2)))
    with R.Ranks("split_mp2", tmp_path) as ranks:
        want = _jax_tokens(jm, _mesh((2,), ("mp",)), prompts)
        outs = ranks.results()
    _assert_served(outs, "mp", want)
    for r, out in enumerate(outs):
        # each rank's cache holds its one K/V head of two
        assert out["mp"]["paged"]["kv_heads"] == 1
        st = out["live_stats"]
        assert st["plans"] > 0 and st["assembled"] == 0, st
        # the live move and the sharded save give the whole weights'
        # tokens (another model's than the JAX one's)
        assert out["live"] == out["whole"] == out["from_save"]
        assert out["whole"] != want["paged"]
        assert out["refuse"].startswith("ValueError") \
            and "cannot change" in out["refuse"], out["refuse"]
    # the plans' wire bytes are what the two ranks received, together
    assert sum(o["live_stats"]["bytes_received"] for o in outs) \
        == outs[0]["live_stats"]["bytes_wire"]
    # the loaded qkv block: each rank's heads of q, of k and of v
    for r, out in enumerate(outs):
        assert torch.equal(out["qkv_block"], local_block(
            out["whole_qkv"], 1, r, 2, segments=(64, 32, 32)))


def test_split_serving_at_ep2(tmp_path):
    jm, params = _moe_jax_model()
    jm.eval()
    prompts = _shared_prefix_prompts(PROMPT_SEED)
    _inputs(tmp_path, prompts,
            moe_params={k: torch.from_numpy(v) for k, v in params.items()})
    with R.Ranks("split_ep2", tmp_path) as ranks:
        want = _jax_tokens(jm, _mesh((2,), ("ep",)), prompts)
        outs = ranks.results()
    _assert_served(outs, "ep", want)


def test_split_serving_at_ep2_mp2(tmp_path):
    jm, params = _moe_jax_model()
    jm.eval()
    prompts = _shared_prefix_prompts(PROMPT_SEED)
    _inputs(tmp_path, prompts,
            moe_params={k: torch.from_numpy(v) for k, v in params.items()})
    with R.Ranks("split_ep_mp4", tmp_path, world=4) as ranks:
        want = _jax_tokens(jm, _mesh((2, 2), ("ep", "mp")), prompts)
        outs = ranks.results()
    _assert_served(outs, "ep_mp", want)
    assert all(o["ep_mp"]["paged"]["kv_heads"] == 2 for o in outs)
