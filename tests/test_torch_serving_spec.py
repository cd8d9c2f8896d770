"""The port's prefix cache, speculative decoding and multi-token extend step
against the JAX package's, on the CPU.

Same weights on both sides: a ``gpt_tiny(num_kv_heads=2)`` JAX model with
random numpy weights (std 0.2, so greedy decoding does not collapse onto one
token), converted by ``paddle_tpu_torch.weights`` into the port's
``GPTForCausalLM``. Everything is fp32; the JAX engine runs its CPU default
(the gather + einsum paged attend), the port's engine runs on the CPU,
where each step function runs eagerly and every kernel wrapper takes its
plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.autograd import no_grad
from paddle_tpu.models.gpt import gpt_tiny
from paddle_tpu.serving import Engine as JEngine
from paddle_tpu.serving import EngineConfig as JEngineConfig
from paddle_tpu.serving import PrefixCache as JPrefixCache
from paddle_tpu.serving import SamplingParams as JSamplingParams
from paddle_tpu.serving import kv_cache as jkvc
from paddle_tpu.serving import speculative as jspec
from paddle_tpu.serving.scheduler import PageAllocator as JPageAllocator
from paddle_tpu_torch.models.gpt import GPT_TINY, GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import (Engine, EngineConfig, PageAllocator,
                                      PrefixCache, SamplingParams)
from paddle_tpu_torch.serving import kv_cache as tkvc
from paddle_tpu_torch.serving import sampling as tsampling
from paddle_tpu_torch.serving import speculative as tspec
from paddle_tpu_torch.weights import from_paddle_tpu

# fp32 logits of magnitude ~10 through two blocks: summation order only
LOGIT_TOL = 1e-4
# one fp32 attention output of unit-scale inputs: summation order only
ATTN_TOL = 1e-5


def _random_params(jm, seed):
    rng = np.random.default_rng(seed)
    params = {}
    for name, v in jm.functional_state()[0].items():
        shape = tuple(v.shape)
        if len(shape) >= 2:
            a = 0.2 * rng.standard_normal(shape)
        elif "bias" in name:
            a = 0.05 * rng.standard_normal(shape)
        else:
            a = 1 + 0.1 * rng.standard_normal(shape)
        params[name] = a.astype(np.float32)
    return params


def _port_model(params):
    tm = GPTForCausalLM(GPTConfig(**{**GPT_TINY, "num_kv_heads": 2,
                                     "dropout": 0.0}), device="cpu")
    tm.load_state_dict(from_paddle_tpu(params))
    tm.eval()
    return tm


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model, numpy params) on the same weights."""
    paddle.seed(0)
    jm = gpt_tiny(dropout=0.0, num_kv_heads=2)
    jm.eval()
    params = _random_params(jm, 0)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in params.items()})
    return jm, _port_model(params), params


def _shared_prefix_prompts(seed):
    """Five prompts: a 16-token shared prefix and distinct suffixes, two of
    them a repeated 4-token phrase (n-gram drafts get accepted there), and
    one prompt without the prefix."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(1, 128, 16).tolist()
    phrase = rng.integers(1, 128, 4).tolist()
    return [pre + rng.integers(1, 128, 5).tolist(),
            pre + phrase * 3,
            rng.integers(1, 128, 11).tolist(),
            pre + rng.integers(1, 128, 9).tolist(),
            pre + phrase * 2 + rng.integers(1, 128, 2).tolist()]


# ---------------- paged extend attend and extend_step ----------------------
@pytest.mark.parametrize("ps", [8, 16])
def test_paged_extend_attend_matches_jax(ps):
    """4 tokens per row written, then attended: a row crossing a page edge,
    a row starting on one, and a row whose last two tokens fall past the
    table (written to the trash page). The written pools (live pages) are
    equal and the outputs agree within ``ATTN_TOL``."""
    rng = np.random.default_rng(ps)
    nb, Hkv, Hq, D, T = 4, 2, 4, 16, 4
    table = np.full((3, nb), -1, np.int32)
    table[0, :2] = [5, 2]
    table[1, :3] = [1, 7, 3]
    table[2, :] = [4, 6, 8, 9]
    P = 10
    pos = np.array([ps - 1, 2 * ps, nb * ps - 2], np.int32)
    kp = rng.standard_normal((P, Hkv, ps, D)).astype(np.float32)
    vp = rng.standard_normal((P, Hkv, ps, D)).astype(np.float32)
    q = rng.standard_normal((3, Hq, T, D)).astype(np.float32)
    kn = rng.standard_normal((3, Hkv, T, D)).astype(np.float32)
    vn = rng.standard_normal((3, Hkv, T, D)).astype(np.float32)

    jk = jkvc.paged_write_kv(jnp.asarray(kp), jnp.asarray(kn),
                             jnp.asarray(table), jnp.asarray(pos))
    jv = jkvc.paged_write_kv(jnp.asarray(vp), jnp.asarray(vn),
                             jnp.asarray(table), jnp.asarray(pos))
    want = np.asarray(jkvc.paged_extend_attend(
        jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(pos)))

    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tt, tp = torch.from_numpy(table), torch.from_numpy(pos)
    tkvc.paged_write_kv(tk, torch.from_numpy(kn), tt, tp)
    tkvc.paged_write_kv(tv, torch.from_numpy(vn), tt, tp)
    got = tkvc.paged_extend_attend(torch.from_numpy(q), tk, tv, tt, tp)
    # page 0 (trash) takes row 2's overflow and is never read
    assert np.array_equal(np.asarray(jk)[1:], tk.numpy()[1:])
    assert np.array_equal(np.asarray(jv)[1:], tv.numpy()[1:])
    assert got.shape == (3, Hq, T, D)
    assert np.abs(want - got.numpy()).max() <= ATTN_TOL
    # T = 1 reduces to the decode attend
    one = tkvc.paged_extend_attend(torch.from_numpy(q[:, :, :1]), tk, tv, tt,
                                   tp)
    assert torch.equal(one, tkvc.decode_attend(
        torch.from_numpy(q[:, :, :1]), tkvc.paged_gather(tk, tt),
        tkvc.paged_gather(tv, tt), tp))


def test_extend_step_logits_match_jax(models):
    """``extend_step`` over 5 tokens per row from identical pools: a row
    mid-table and a row at the table's end (position ids clamp at 63, the
    last writes go to the trash page). Logits ``[B, T, V]`` agree within
    ``LOGIT_TOL``, the written pools within 1e-5."""
    jm, tm, _ = models
    rng = np.random.default_rng(5)
    L, Hkv, D, ps, nb, T = 2, 2, 16, 4, 16, 5
    P = 4 + nb + 1
    kp = rng.standard_normal((L, P, Hkv, ps, D)).astype(np.float32)
    vp = rng.standard_normal((L, P, Hkv, ps, D)).astype(np.float32)
    table = np.full((2, nb), -1, np.int32)
    table[0, :4] = [3, 1, 4, 2]
    table[1, :] = np.arange(5, 5 + nb)
    tokens = rng.integers(1, 128, (2, T)).astype(np.int32)
    pos = np.array([11, 61], np.int32)
    with no_grad():
        jl, jnew = jm.extend_step(
            paddle.to_tensor(tokens),
            [(paddle.to_tensor(kp[l]), paddle.to_tensor(vp[l]),
              paddle.to_tensor(table)) for l in range(L)],
            paddle.to_tensor(pos))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tt = torch.from_numpy(table)
    with torch.no_grad():
        tl, _ = tm.extend_step(torch.from_numpy(tokens).long(),
                               [(tk[l], tv[l], tt) for l in range(L)],
                               torch.from_numpy(pos))
    assert tl.shape == (2, T, 128)
    assert np.abs(np.asarray(jl.numpy()) - tl.numpy()).max() <= LOGIT_TOL
    for l, (jk, jv) in enumerate(jnew):
        assert np.abs(np.asarray(jk.numpy())[1:] - tk[l].numpy()[1:]).max() \
            <= 1e-5
        assert np.abs(np.asarray(jv.numpy())[1:] - tv[l].numpy()[1:]).max() \
            <= 1e-5


# ---------------- the host halves -----------------------------------------
def test_propose_and_accept_match_jax():
    rng = np.random.default_rng(11)
    for n in (0, 1, 2, 5, 17, 40):
        ctx = rng.integers(0, 5, n).tolist()
        for k in (1, 3, 5):
            for g in (1, 2, 3):
                assert tspec.propose_ngram(ctx, k, g) \
                    == jspec.propose_ngram(ctx, k, g)
    for _ in range(50):
        k = int(rng.integers(1, 6))
        drafts = rng.integers(0, 3, k).tolist()
        targets = rng.integers(0, 3, k + 1).tolist()
        assert tspec.accept_greedy(drafts, targets) \
            == jspec.accept_greedy(drafts, targets)
    with pytest.raises(ValueError):
        tspec.SpeculativeConfig(k=0)
    with pytest.raises(ValueError):
        tspec.SpeculativeConfig(ngram=0)


def _trie_trace(cache_cls, alloc_cls):
    """One allocator trace through the trie: inserts, matches (the cap, a
    partial block, a miss), splices, frees, LRU eviction past a live
    sharer, and a clear. Returns what each call returned and the pool's
    state after it."""
    alloc = alloc_cls(12)
    pc = cache_cls(4, alloc)
    out = []

    def note(what, value):
        out.append((what, value, alloc.num_free,
                    {p: alloc.refcount(p) for p in range(1, 12)}))

    a = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13]
    pa = alloc.alloc(4, owner="a")
    note("insert a", pc.insert(a, pa[:3]))
    b = a[:8] + [20, 21, 22, 23, 24]
    hit, pages = pc.match(b)
    note("match b", (hit, pages))
    alloc.retain(pages, owner="b")
    pb = alloc.alloc(2, owner="b")
    note("insert b", pc.insert(b, pages + pb))
    note("match a[:12] (cap)", pc.match(a[:12]))
    note("match a[:6] (partial block)", pc.match(a[:6]))
    note("match miss", pc.match([99] * 9))
    alloc.free(pa, owner="a")
    note("free a", None)
    note("evict to 9 free", pc.evict_lru(9))
    note("evict to 12 free", pc.evict_lru(12))
    alloc.free(pages + pb, owner="b")
    note("free b", None)
    c = [5] * 9
    pc_pages = alloc.alloc(3, owner="c")
    note("insert c", pc.insert(c, pc_pages[:2]))
    note("clear", pc.clear())
    alloc.free(pc_pages, owner="c")
    note("free c", pc.num_nodes)
    return out


def test_prefix_trie_matches_jax_on_one_trace():
    want = _trie_trace(JPrefixCache, JPageAllocator)
    got = _trie_trace(PrefixCache, PageAllocator)
    assert got == want
    assert got[-1][2] == 11  # every page free again


# ---------------- the engine ----------------------------------------------
@pytest.mark.parametrize("opts,max_seq_len,max_new", [
    (dict(prefix_cache=True), 64, 12),
    (dict(speculative=3), 64, 12),
    (dict(prefix_cache=True, speculative=3), 64, 12),
    # the verify step drafts past S_max: cache_full with speculation on
    (dict(prefix_cache=True, speculative=2), 40, 30),
])
def test_engine_options_greedy_tokens_match_jax(models, opts, max_seq_len,
                                                max_new):
    """Five prompts through 2 slots (mid-run admission, prefix hits,
    accepted drafts): greedy tokens and finish reasons identical to the JAX
    engine with the same options and to the port's plain engine; the page
    pool is whole again once the trie is cleared."""
    jm, tm, _ = models
    prompts = _shared_prefix_prompts(3)
    cfg = dict(max_batch_size=2, max_seq_len=max_seq_len, page_size=8)
    jeng = JEngine(jm, JEngineConfig(**cfg, **opts))
    jreqs = [jeng.add_request(p, JSamplingParams(max_new_tokens=max_new))
             for p in prompts]
    while jeng.has_unfinished:
        jeng.step()
    eng = Engine(tm, EngineConfig(**cfg, **opts), device="cpu")
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=max_new))
            for p in prompts]
    while eng.has_unfinished:
        eng.step()
    plain = Engine(tm, EngineConfig(**cfg), device="cpu").generate(
        prompts, SamplingParams(max_new_tokens=max_new))
    got = [r.output_ids for r in reqs]
    assert got == [r.output_ids for r in jreqs]
    assert [r.finish_reason for r in reqs] \
        == [r.finish_reason for r in jreqs]
    assert got == plain
    assert len({t for o in got for t in o}) > 4  # not one repeated token
    if opts.get("prefix_cache"):
        assert [r.prefix_hit_blocks for r in reqs] \
            == [r.prefix_hit_blocks for r in jreqs]
        assert sum(r.prefix_hit_blocks > 0 for r in reqs) == 3
        eng.prefix_cache.clear()
    if opts.get("speculative"):
        assert [r.accepted_tokens for r in reqs] \
            == [r.accepted_tokens for r in jreqs]
        assert eng.spec_accepted > 0
    if max_seq_len == 40:
        assert "cache_full" in [r.finish_reason for r in reqs]
    assert eng.page_alloc.num_free == eng.page_alloc.num_allocatable
    assert eng.cache.free_slots == 2
    assert eng.steps and all(s.captures == 0 for s in eng.steps.values())


def test_admission_evicting_its_own_match_keeps_the_prefix(models):
    """A pool so short that admitting a prefix hit evicts the trie down to
    the matched chain: the splice holds its pages from the match on, so
    eviction frees none of them and no page is handed out twice. The
    request waits for the running one to finish instead, and every
    request's tokens equal those of the plain engine on a full pool."""
    _, tm, _ = models
    rng = np.random.default_rng(7)
    pre = rng.integers(1, 128, 16).tolist()
    # C runs throughout; A puts the 2-block prefix in the trie and
    # finishes; B then matches it and needs 3 pages more than are free
    prompts = [rng.integers(1, 128, 20).tolist(), pre + [5],
               pre + rng.integers(1, 128, 16).tolist()]
    sps = [SamplingParams(max_new_tokens=n) for n in (20, 2, 4)]
    cfg = dict(max_batch_size=2, max_seq_len=64, page_size=8)
    eng = Engine(tm, EngineConfig(**cfg, kv_pages=8, prefix_cache=True),
                 device="cpu")
    reqs = [eng.add_request(p, sp) for p, sp in zip(prompts, sps)]
    while eng.has_unfinished:
        eng.step()
        for slot, req in enumerate(eng._slots):
            pages = [int(p) for p in eng.cache.page_table[slot] if p > 0]
            assert req is not None or not pages
            assert len(set(pages)) == len(pages)
        live = [int(p) for p in eng.cache.page_table.ravel() if p > 0]
        assert all(eng.page_alloc._refs.get(p, 0) >= live.count(p)
                   for p in live)
    plain = [Engine(tm, EngineConfig(**cfg), device="cpu").generate([p], sp)[0]
             for p, sp in zip(prompts, sps)]
    assert [r.output_ids for r in reqs] == plain
    assert [r.finish_reason for r in reqs] == ["length"] * 3
    # B was admitted only once C had finished, without its prefix
    assert reqs[2].first_token_time > reqs[0].finish_time
    assert reqs[2].prefix_hit_blocks == 0
    eng.prefix_cache.clear()
    assert eng.page_alloc.num_free == eng.page_alloc.num_allocatable


def test_sampled_rows_emit_one_token_per_verify_step(models):
    """With speculation on, a sampled row ignores drafts and emits position
    0's sample each step, beside a greedy row in the same batch; two
    engines on the same seed draw the same tokens."""
    _, tm, _ = models
    prompts = _shared_prefix_prompts(4)[:2]
    sps = [SamplingParams(max_new_tokens=6),
           SamplingParams(max_new_tokens=6, do_sample=True, temperature=0.8,
                          top_k=5)]

    def run():
        eng = Engine(tm, EngineConfig(max_batch_size=2, max_seq_len=64,
                                      page_size=8, speculative=2),
                     device="cpu",
                     generator=torch.Generator().manual_seed(3))
        reqs = [eng.add_request(p, sp) for p, sp in zip(prompts, sps)]
        while eng.has_unfinished:
            eng.step()
        return reqs

    first, second = run(), run()
    assert [len(r.output_ids) for r in first] == [6, 6]
    assert first[1].draft_tokens == 0 and first[0].draft_tokens > 0
    assert [r.output_ids for r in first] == [r.output_ids for r in second]


def test_load_weights_copies_in_place_and_checks(models):
    """``load_weights`` copies into the existing parameters (the same
    tensors), after which the engine serves what a fresh engine on the new
    weights serves; missing names, shapes and dtypes raise and copy
    nothing."""
    jm, tm, params = models
    new = _random_params(jm, 1)
    fresh = Engine(_port_model(new), EngineConfig(max_batch_size=2,
                                                  max_seq_len=64),
                   device="cpu")
    model = _port_model(params)
    eng = Engine(model, EngineConfig(max_batch_size=2, max_seq_len=64),
                 device="cpu")
    prompts = _shared_prefix_prompts(5)[:3]
    sp = SamplingParams(max_new_tokens=5)
    before = eng.generate(prompts, sp)
    ids = {n: p.data_ptr() for n, p in model.state_dict(keep_vars=True)
           .items()}
    sd = from_paddle_tpu(new)
    bad_shape = dict(sd, **{"gpt.final_ln.bias": torch.zeros(3)})
    bad_dtype = dict(sd, **{"gpt.final_ln.bias":
                            sd["gpt.final_ln.bias"].double()})
    missing = {k: v for k, v in sd.items() if k != "gpt.final_ln.bias"}
    with pytest.raises(ValueError, match="final_ln.bias"):
        eng.load_weights(bad_shape)
    with pytest.raises(ValueError, match="final_ln.bias"):
        eng.load_weights(bad_dtype)
    with pytest.raises(KeyError, match="missing"):
        eng.load_weights(missing)
    assert eng.generate(prompts, sp) == before  # nothing was copied
    eng.load_weights({k: v.numpy() for k, v in sd.items()})
    assert eng.generate(prompts, sp) == fresh.generate(prompts, sp)
    assert {n: p.data_ptr() for n, p in model.state_dict(keep_vars=True)
            .items()} == ids
    eng.load_weights(missing, allow_missing=True)
    assert eng.generate(prompts, sp) == fresh.generate(prompts, sp)


def test_load_weights_takes_the_reference_signature(models):
    """``load_weights(params, shardings=None, allow_missing=False)``, as the
    reference: a positional ``shardings`` dict is read as the layout (not
    as ``allow_missing``), so a missing name still raises and nothing is
    copied; ``shardings={}`` (falsy) and a None entry keep the current
    layout and load; a placement the built model does not hold raises,
    copying nothing; ``load_weights(params, None, True)`` loads."""
    from paddle_tpu_torch.distributed.mesh import (DeviceMesh, NamedSharding,
                                                   PartitionSpec)

    jm, tm, params = models
    model = _port_model(params)
    eng = Engine(model, EngineConfig(max_batch_size=2, max_seq_len=64),
                 device="cpu")
    before = {n: p.clone() for n, p in model.state_dict().items()}
    sd = from_paddle_tpu(_random_params(jm, 1))
    missing = {k: v for k, v in sd.items() if k != "gpt.final_ln.bias"}
    with pytest.raises(KeyError, match="missing"):
        eng.load_weights(missing, {"gpt.final_ln.bias": None})
    own = eng.shardings()
    assert own["gpt.final_ln.bias"].is_replicated
    other = NamedSharding(DeviceMesh([0], ("mp",)), PartitionSpec("mp"))
    with pytest.raises(ValueError, match="cannot change"):
        eng.load_weights(sd, shardings={"gpt.final_ln.bias": other})
    assert all(torch.equal(before[n], p)
               for n, p in model.state_dict().items())
    eng.load_weights(sd, shardings={})
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    eng.load_weights({k: before[k] for k in sd},
                     {"gpt.final_ln.bias": None, **{
                         k: own[k] for k in list(own)[:3]}})
    assert all(torch.equal(before[n], p)
               for n, p in model.state_dict().items())
    eng.load_weights(missing, None, True)
    got = model.state_dict()
    assert torch.equal(got["gpt.final_ln.bias"], before["gpt.final_ln.bias"])
    assert all(torch.equal(got[k], v) for k, v in missing.items())


def test_engine_config_speculative_forms(models):
    assert EngineConfig(speculative=True).speculative.k == 3
    assert EngineConfig(speculative=5).speculative.k == 5
    assert EngineConfig(speculative=False).speculative is None
    cfg = tspec.SpeculativeConfig(k=2, ngram=1)
    assert EngineConfig(speculative=cfg).speculative is cfg
    with pytest.raises(ValueError, match="speculative"):
        EngineConfig(speculative="yes")
    with pytest.raises(ValueError, match="verify"):
        Engine(models[1], EngineConfig(max_seq_len=64), device="cpu") \
            .step_program("verify")


# ---------------- sampling --------------------------------------------------
def test_sample_batched_greedy_exact_and_draws_every_call():
    """Sampled rows draw from their temperature-scaled, top-k filtered
    distribution; greedy rows are the exact argmax (the first maximum on
    ties); and every call draws, greedy batch or not (nothing is read on
    the host, so a CUDA graph can capture the call)."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((6, 50)).astype(np.float32))
    logits[0, [3, 7]] = 9.0  # a tie: row 0 takes 3
    temps = torch.tensor([1.0, 0.7, 1.3, 1.0, 0.5, 2.0])
    top_ks = torch.tensor([0, 5, 0, 50, 1, 10], dtype=torch.int32)
    greedy = torch.tensor([True, False, False, False, False, True])
    got = tsampling.sample_batched(logits, torch.Generator().manual_seed(9),
                                   temps, top_ks, greedy)
    scaled = logits / temps[:, None]
    kth = torch.sort(scaled, dim=-1, descending=True).values.gather(
        1, (top_ks.long() - 1).clamp(0, 49)[:, None])
    on = ((top_ks > 0) & (top_ks < 50))[:, None] & (scaled < kth)
    probs = torch.softmax(scaled.masked_fill(on, -1e30), dim=-1)
    want = torch.multinomial(probs, 1,
                             generator=torch.Generator().manual_seed(9))[:, 0]
    assert torch.equal(got[~greedy], want[~greedy])
    assert got[0] == 3 and got[5] == logits[5].argmax()
    assert got[4] == logits[4].argmax()  # top-1
    assert got[1] in torch.topk(scaled[1], 5).indices
    g = torch.Generator().manual_seed(1)
    state = g.get_state()
    tsampling.sample_batched(logits, g, temps, top_ks,
                             torch.ones(6, dtype=torch.bool))
    assert not torch.equal(g.get_state(), state)
