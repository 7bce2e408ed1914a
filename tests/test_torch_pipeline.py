"""The port's device step against the reference's, register by register.

Four chunks (salt = chunk index) of the same wire-layout batches go
through the reference's ``pipeline.analysis_step`` and the port's
``analysis_step``.  After every chunk ``counts_lo/hi``, ``cms``, ``hll``,
``talk_cms`` and the ChunkOut candidates must be bit-identical, for both
of the port's match impls (on CPU they run the kernels' plain versions).
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from ruleset_analysis_tpu.config import AnalysisConfig as JConfig  # noqa: E402
from ruleset_analysis_tpu.config import SketchConfig as JSketch  # noqa: E402
from ruleset_analysis_tpu.hostside import aclparse, pack, synth  # noqa: E402
from ruleset_analysis_tpu.models import pipeline as jpipe  # noqa: E402
from ruleset_analysis_tpu_torch.config import AnalysisConfig, SketchConfig  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import pack as tpack  # noqa: E402
from ruleset_analysis_tpu_torch.models import pipeline  # noqa: E402

B = 512
N_CHUNKS = 4
SKETCH = dict(cms_width=1 << 10, cms_depth=2, hll_p=6)


@pytest.fixture(scope="module")
def case():
    cfg_text = synth.synth_config(n_acls=3, rules_per_acl=18, seed=31)
    packed = pack.pack_rulesets([aclparse.parse_asa_config(cfg_text, "fw1")])
    rng = np.random.default_rng(31)
    batches = []
    for c in range(N_CHUNKS):
        t = synth.synth_tuples(packed, B, seed=100 + c)
        t[rng.random(B) < 0.1, 6] = 0  # some invalid lines
        t[rng.random(B) < 0.02, 0] = 5  # corrupt acl ids
        batches.append(pack.compact_batch(np.ascontiguousarray(t.T)))
    jcfg = JConfig(batch_size=B, sketch=JSketch(**SKETCH))
    step = jax.jit(functools.partial(
        jpipe.analysis_step, n_keys=packed.n_keys,
        topk_k=jcfg.sketch.topk_chunk_candidates,
    ))
    jrules = jpipe.ship_ruleset(packed)
    state = jpipe.init_state(packed.n_keys, jcfg)
    ref = []
    for c, wire in enumerate(batches):
        state, out = step(state, jrules, wire, salt=np.uint32(c))
        ref.append((jpipe.state_to_host(state), [np.asarray(x) for x in out]))
    return packed, batches, ref


@pytest.mark.parametrize("impl", ["fused", "scan"])
def test_registers_bit_identical_chunk_by_chunk(case, impl):
    packed, batches, ref = case
    cfg = AnalysisConfig(batch_size=B, sketch=SketchConfig(**SKETCH), match_impl=impl, device="cpu")
    rules = pipeline.ship_ruleset(packed, "cpu")
    state = pipeline.init_state(packed.n_keys, cfg, "cpu")
    for c, wire in enumerate(batches):
        state, out = pipeline.analysis_step(
            state, rules, torch.from_numpy(wire.view(np.int32)),
            n_keys=packed.n_keys, topk_k=cfg.sketch.topk_chunk_candidates,
            salt=c, match_impl=impl,
        )
        want_state, want_out = ref[c]
        got = pipeline.state_to_numpy(state)
        for k in pipeline.AnalysisState._fields:
            np.testing.assert_array_equal(got[k], want_state[k], err_msg=f"chunk {c} {k}")
        for name, g, w in zip(pipeline.ChunkOut._fields, out, want_out):
            np.testing.assert_array_equal(g.numpy().astype(np.uint32), w, err_msg=f"chunk {c} {name}")


def test_tuple_layout_steps_like_wire_layout(case):
    packed, batches, ref = case
    cfg = AnalysisConfig(batch_size=B, sketch=SketchConfig(**SKETCH), device="cpu")
    rules = pipeline.ship_ruleset(packed, "cpu")
    state = pipeline.init_state(packed.n_keys, cfg, "cpu")
    tuples = pack.expand_batch(batches[0])
    state, out = pipeline.analysis_step(
        state, rules, torch.from_numpy(tuples.view(np.int32)),
        n_keys=packed.n_keys, topk_k=cfg.sketch.topk_chunk_candidates, salt=0,
    )
    got = pipeline.state_to_numpy(state)
    for k in pipeline.AnalysisState._fields:
        np.testing.assert_array_equal(got[k], ref[0][0][k], err_msg=k)


def test_state_round_trips_between_packages(case):
    packed, _, ref = case
    host = ref[-1][0]
    state = pipeline.state_from_numpy(host, "cpu")
    back = pipeline.state_to_numpy(state)
    for k in pipeline.AnalysisState._fields:
        assert back[k].dtype == np.uint32
        np.testing.assert_array_equal(back[k], host[k])
    assert pipeline.counts_total(state) == int(
        (host["counts_lo"].astype(np.uint64) + (host["counts_hi"].astype(np.uint64) << np.uint64(32))).sum()
    )


def test_ipv6_ruleset_is_refused():
    from ruleset_analysis_tpu_torch.errors import NotPorted
    from ruleset_analysis_tpu_torch.hostside import aclparse as taclparse
    from ruleset_analysis_tpu_torch.hostside import synth as tsynth

    text = tsynth.synth_config(n_acls=2, rules_per_acl=20, seed=3, v6_fraction=0.5)
    packed = tpack.pack_rulesets([taclparse.parse_asa_config(text, "fw1")])
    assert packed.has_v6
    with pytest.raises(NotPorted, match="IPv6"):
        pipeline.ship_ruleset(packed, "cpu")


def test_register_budget_is_enforced():
    cfg = AnalysisConfig(register_memory_budget_bytes=1 << 20)
    with pytest.raises(ValueError, match="try --hll-p"):
        pipeline.init_state(4096, cfg, "cpu")
