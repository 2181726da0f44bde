"""The port's radix prefix cache (``accelerate_tpu_torch/serving/radix.py``)
and its prefix-aware admission held against the JAX package's
``serving/radix.py`` and ``serving/scheduler.py``: one seeded sequence of
``acquire`` / ``insert`` / ``release_acquired`` / ``evict`` calls (and, on
the schedulers, ``admit`` / ``grow_for_decode`` / ``evict_finished``) on
both gives identical match lengths, blocks, copy-on-write sources,
refcounts and eviction counts. Pure host code: no model, no device."""

import numpy as np
import pytest

from accelerate_tpu.serving import blocks as jblocks
from accelerate_tpu.serving import radix as jradix
from accelerate_tpu.serving import scheduler as jsched
from accelerate_tpu_torch.serving import blocks as tblocks
from accelerate_tpu_torch.serving import radix as tradix
from accelerate_tpu_torch.serving import scheduler as tsched

BS = 4


def _pair(num_blocks):
    ja, ta = jblocks.BlockAllocator(num_blocks), tblocks.BlockAllocator(num_blocks)
    return (ja, jradix.RadixCache(ja, BS)), (ta, tradix.RadixCache(ta, BS))


def _state(alloc, cache):
    return {
        "free": alloc.free_count,
        "allocated": alloc.allocated_count,
        "refcounts": {b: alloc.refcount(b) for b in range(alloc.num_blocks)},
        "cached": cache.cached_block_count,
        "exclusive": cache.exclusive_block_count(),
        "inserted": cache.inserted_blocks,
        "evicted": cache.evicted_blocks,
    }


def _prompts(rng, n):
    """Prompts over a small alphabet that share prefixes: whole-block and
    partial-block agreements, and divergences inside a block."""
    stems = [rng.integers(0, 3, size=int(rng.integers(2, 14))).tolist() for _ in range(4)]
    return [stems[int(rng.integers(0, 4))] + rng.integers(0, 3, size=int(rng.integers(1, 9)))
            .tolist() for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_acquire_insert_evict_sequence_matches_jax(seed):
    rng = np.random.default_rng(seed)
    (ja, jc), (ta, tc) = _pair(num_blocks=24)
    live = []  # (prompt, blocks of each package)
    cows = 0
    for prompt in _prompts(rng, 40):
        op = rng.integers(0, 4)
        if op == 3 and live:
            # a request finishes: its blocks are decref'd, the cache's stay
            _, jb, tb = live.pop(int(rng.integers(0, len(live))))
            ja.decref(jb)
            ta.decref(tb)
        elif op == 2:
            want = int(rng.integers(1, 5))
            assert tc.evict(want) == jc.evict(want)
        else:
            got_j, got_t = jc.acquire(prompt), tc.acquire(prompt)
            assert got_t == got_j  # (blocks, matched tokens, cow source)
            blocks, matched, cow = got_j
            cows += cow is not None
            need = -(-(len(prompt) + 1) // BS) - len(blocks)
            if need > ja.free_count:
                jc.release_acquired(blocks, cow)
                tc.release_acquired(blocks, cow)
                continue
            jb, tb = blocks + ja.allocate(need), blocks + ta.allocate(need)
            assert jb == tb
            if cow is not None:  # the engine's copy ran: drop the pin
                ja.decref([cow])
                ta.decref([cow])
            assert tc.insert(prompt, tb) == jc.insert(prompt, jb)
            live.append((prompt, jb, tb))
        assert _state(ta, tc) == _state(ja, jc)
        assert all(tc.is_cached(b) == jc.is_cached(b) for b in range(24))
    # the sequence evicted, inserted and owed copy-on-write copies
    assert jc.evicted_blocks > 0 and jc.inserted_blocks > 0 and cows > 0


def test_match_is_pure_and_capped_like_jax():
    (ja, jc), (ta, tc) = _pair(num_blocks=16)
    prompt = list(range(10))
    for alloc, cache in ((ja, jc), (ta, tc)):
        cache.insert(prompt, alloc.allocate(3))
    for probe in (prompt, prompt[:8], prompt[:8] + [99], prompt[:6] + [7, 7], [5]):
        assert tc.match(probe) == jc.match(probe)
    assert _state(ta, tc) == _state(ja, jc)  # match touches no refcount


def _sched_pair(num_blocks, num_slots=2):
    (ja, jc), (ta, tc) = _pair(num_blocks)
    js = jsched.SlotScheduler(num_slots, ja, BS, 64, radix=jc)
    ts = tsched.SlotScheduler(num_slots, ta, BS, 64, radix=tc)
    return js, ts


@pytest.mark.parametrize("seed", [0, 1])
def test_prefix_aware_admission_and_growth_match_jax(seed):
    """The schedulers admit with the cache (hits, copy-on-write sources,
    evictions under a tight pool), grow decode lanes and evict finished
    requests in lockstep."""
    rng = np.random.default_rng(seed)
    js, ts = _sched_pair(num_blocks=14)
    reqs = []
    for prompt in _prompts(rng, 24):
        budget = int(rng.integers(1, 8))
        reqs.append((js.submit(jsched.Request(prompt=list(prompt), max_new_tokens=budget)),
                     ts.submit(tsched.Request(prompt=list(prompt), max_new_tokens=budget))))
    for _ in range(200):
        admitted = [(j.request_id, j.matched_tokens, j.cow, list(j.blocks)) for j in js.admit()]
        got = [(t.matched_tokens, t.cow, list(t.blocks)) for t in ts.admit()]
        assert [a[1:] for a in admitted] == got
        for j, t in reqs:
            if j.cow is not None:
                js.allocator.decref([j.cow[0]])
                ts.allocator.decref([t.cow[0]])
                j.cow = t.cow = None
            if j.state is jsched.RequestState.PREFILL:
                j.prefill_pos = t.prefill_pos = j.prompt_len
                js.radix.insert(j.prompt, j.blocks)
                ts.radix.insert(t.prompt, t.blocks)
                j.state, t.state = jsched.RequestState.DECODE, tsched.RequestState.DECODE
            elif j.state is jsched.RequestState.DECODE:
                grew = js.grow_for_decode(j, tokens_ahead=2)
                assert ts.grow_for_decode(t, tokens_ahead=2) == grew
                j.output_tokens.append(1)
                t.output_tokens.append(1)
                if not grew or len(j.output_tokens) >= j.max_new_tokens:
                    j.state, t.state = jsched.RequestState.FINISHED, tsched.RequestState.FINISHED
            assert list(t.blocks) == list(j.blocks)
        js.evict_finished()
        ts.evict_finished()
        assert _state(ts.allocator, ts.radix) == _state(js.allocator, js.radix)
        assert (ts.prefix_hit_tokens, ts.prompt_tokens_admitted) == (
            js.prefix_hit_tokens, js.prompt_tokens_admitted)
        if not js.has_work():
            break
    assert not ts.has_work()
    assert js.prefix_hit_tokens > 0 and js.radix.evicted_blocks > 0
