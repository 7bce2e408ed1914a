"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips with a
reason when no CUDA device is present (decided when the test runs, never
at import).  Run on a machine with an NVIDIA H100:

    python -m pytest tests/test_torch_cuda.py -m gpu
"""

import numpy as np
import pytest
import torch

from ruleset_analysis_tpu_torch.config import AnalysisConfig, SketchConfig
from ruleset_analysis_tpu_torch.hostside import aclparse, pack, synth
from ruleset_analysis_tpu_torch.models import pipeline
from ruleset_analysis_tpu_torch.ops import first_match, match_hist

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine with -m gpu)")
    return torch.device("cuda")


def _case(n_acls, rules_per_acl, n, seed=0):
    text = synth.synth_config(n_acls=n_acls, rules_per_acl=rules_per_acl, seed=seed)
    packed = pack.pack_rulesets([aclparse.parse_asa_config(text, "fw1")])
    tuples = synth.synth_tuples(packed, n, seed=seed + 1)
    return packed, tuples


def _fields(tuples, dev):
    return [torch.from_numpy(np.ascontiguousarray(tuples[:, i]).view(np.int32)).to(dev)
            for i in range(7)]


@pytest.mark.parametrize("n_acls,rules,n", [(3, 24, 2048), (4, 64, 1000), (16, 256, 4099)])
def test_first_match_kernel_equals_plain(cuda, n_acls, rules, n):
    packed, tuples = _case(n_acls, rules, n)
    r = pipeline.ship_ruleset(packed, cuda)
    f = _fields(tuples, cuda)[:6]
    before = first_match.first_match_rows.launches
    got = first_match.first_match_rows(f, r.rules_fm)
    torch.cuda.synchronize()
    assert first_match.first_match_rows.launches == before + 1
    assert torch.equal(got, first_match.first_match_rows_plain(f, r.rules_fm))


@pytest.mark.parametrize("force_global", [False, True])
@pytest.mark.parametrize("n_acls,rules,n", [(3, 24, 2048), (16, 256, 4099)])
def test_match_hist_kernel_equals_plain(cuda, n_acls, rules, n, force_global):
    packed, tuples = _case(n_acls, rules, n)
    tuples[::5, 6] = 0  # invalid lines
    tuples[::11, 0] = 0xFFFFFFF0  # corrupt acl ids
    r = pipeline.ship_ruleset(packed, cuda)
    f = _fields(tuples, cuda)
    got = match_hist.match_rows_and_hists(f[:6], f[6], r.rules_fm, packed.n_acls,
                                          force_global=force_global)
    torch.cuda.synchronize()
    want = match_hist.match_rows_and_hists_plain(f[:6], f[6], r.rules_fm, packed.n_acls)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_empty_and_all_invalid_batches(cuda):
    packed, tuples = _case(2, 8, 300)
    r = pipeline.ship_ruleset(packed, cuda)
    f = _fields(tuples, cuda)
    empty = [x[:0] for x in f]
    assert first_match.first_match_rows(empty[:6], r.rules_fm).numel() == 0
    row, hr, hd = match_hist.match_rows_and_hists(f[:6], torch.zeros_like(f[6]), r.rules_fm, 2)
    torch.cuda.synchronize()
    assert int(hr.sum()) == 0 and int(hd.sum()) == 0


@pytest.mark.parametrize("impl", ["fused", "scan"])
def test_step_on_the_card_equals_the_cpu_step(cuda, impl):
    packed, tuples = _case(3, 18, 1536, seed=4)
    tuples[::9, 6] = 0
    wire = pack.compact_batch(np.ascontiguousarray(tuples.T))
    cfg = AnalysisConfig(batch_size=1536, sketch=SketchConfig(cms_width=1 << 10, cms_depth=2, hll_p=6))
    outs = []
    for dev in (torch.device("cpu"), cuda):
        rules = pipeline.ship_ruleset(packed, dev)
        state = pipeline.init_state(packed.n_keys, cfg, dev)
        for salt in range(3):
            state, out = pipeline.analysis_step(
                state, rules, torch.from_numpy(wire.view(np.int32)).to(dev),
                n_keys=packed.n_keys, topk_k=64, salt=salt, match_impl=impl,
            )
        outs.append((pipeline.state_to_numpy(state), [x.cpu() for x in out]))
    (cs, co), (gs, go) = outs
    for k in cs:
        np.testing.assert_array_equal(gs[k], cs[k], err_msg=k)
    for a, b in zip(co, go):
        assert torch.equal(a, b)


def test_wrapper_refuses_mixed_devices(cuda):
    packed, tuples = _case(2, 8, 64)
    r = pipeline.ship_ruleset(packed, cuda)
    f = _fields(tuples, torch.device("cpu"))[:6]
    with pytest.raises(ValueError, match="device"):
        first_match.first_match_rows(f, r.rules_fm)
