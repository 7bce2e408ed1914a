"""runtime.timing of the port: counts-closed step windows catch fake execution.

Mirrors tests/test_timing.py on the port (its step on the CPU runs the
kernels' plain versions), and holds the measured delta and the state the
window leaves to the reference's ``timed_validated_steps`` over the same
feeds.  Tolerance 0.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from ruleset_analysis_tpu.config import AnalysisConfig as JConfig  # noqa: E402
from ruleset_analysis_tpu.config import SketchConfig as JSketch  # noqa: E402
from ruleset_analysis_tpu.hostside import pack as rpack  # noqa: E402
from ruleset_analysis_tpu.models import pipeline as jpipe  # noqa: E402
from ruleset_analysis_tpu.runtime import timing as rtiming  # noqa: E402
from ruleset_analysis_tpu_torch.config import AnalysisConfig, SketchConfig  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import aclparse, pack, synth  # noqa: E402
from ruleset_analysis_tpu_torch.models import pipeline  # noqa: E402
from ruleset_analysis_tpu_torch.runtime.ingest import host_tensor  # noqa: E402
from ruleset_analysis_tpu_torch.runtime.timing import timed_validated_steps  # noqa: E402

B = 256
ITERS = 4
SKETCH = dict(cms_width=1 << 10, cms_depth=2, hll_p=5)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("timing")
    text = synth.synth_config(n_acls=2, rules_per_acl=8, seed=81)
    packed = pack.pack_rulesets([aclparse.parse_asa_config(text, "fw1")])
    pack.save_packed(packed, str(d / "fw1"))
    cfg = AnalysisConfig(batch_size=B, sketch=SketchConfig(**SKETCH), device="cpu")
    feeds, valid = [], []
    for seed in (81, 82):
        b = np.ascontiguousarray(synth.synth_tuples(packed, B, seed=seed).T)
        b[pack.T_VALID, ::7] = 0  # some invalid lines
        feeds.append(pack.compact_batch(b))
        valid.append(int(b[pack.T_VALID].sum()))
    step = functools.partial(pipeline.analysis_step, n_keys=packed.n_keys,
                             topk_k=cfg.sketch.topk_chunk_candidates)
    return packed, rpack.load_packed(str(d / "fw1")), cfg, step, feeds, valid


def test_real_execution_validates_as_the_reference(setup):
    packed, rpacked, cfg, step, feeds, valid = setup
    state = pipeline.init_state(packed.n_keys, cfg, CPU)
    state, dt, delta, expect = timed_validated_steps(
        step, state, pipeline.ship_ruleset(packed, CPU), [host_tensor(f) for f in feeds],
        valid, ITERS)
    assert delta == expect == 2 * (valid[0] + valid[1])
    assert dt > 0
    jcfg = JConfig(batch_size=B, sketch=JSketch(**SKETCH))
    jstep = jax.jit(functools.partial(jpipe.analysis_step, n_keys=rpacked.n_keys,
                                      topk_k=jcfg.sketch.topk_chunk_candidates))
    jstate, _, jdelta, jexpect = rtiming.timed_validated_steps(
        jstep, jpipe.init_state(rpacked.n_keys, jcfg), jpipe.ship_ruleset(rpacked), feeds,
        valid, ITERS)
    assert (jdelta, jexpect) == (delta, expect)
    # the same salt (0) every step on both sides: the registers agree too
    regs = pipeline.state_to_numpy(state)
    for k in ("counts_lo", "counts_hi", "cms", "hll", "talk_cms"):
        np.testing.assert_array_equal(regs[k], np.asarray(getattr(jstate, k)), err_msg=k)


def test_fake_step_is_caught(setup):
    """A step that never runs (returns its inputs) shows delta = 0."""
    packed, _, cfg, _, feeds, valid = setup

    def fake_step(state, rules, batch):
        return state, None

    state = pipeline.init_state(packed.n_keys, cfg, CPU)
    state, _dt, delta, expect = timed_validated_steps(
        fake_step, state, pipeline.ship_ruleset(packed, CPU), feeds, valid, ITERS)
    assert delta == 0
    assert expect == 2 * (valid[0] + valid[1])
    assert delta != expect  # the caller's integrity check fires
