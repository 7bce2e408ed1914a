"""Shared harness of the port's fault, retry, trace and flight-recorder
parity tests (test_torch_retry, test_torch_chaos, test_torch_obs,
test_torch_flightrec).

Both packages keep process-wide arming state in their ``faults``,
``retrypolicy``, ``obs`` and ``flightrec`` modules, and export the same
environment variables (``RA_FAULT_PLAN``, ``RA_TRACE_DIR``,
``RA_BLACKBOX_DIR``) to the workers they spawn.  So the two sides run one
after the other, each disarmed before the other starts
(:func:`reset_all`), and a :class:`Side` bundles one package's modules so
a test drives both through the same code.
"""

from __future__ import annotations

import contextlib
import json
import random

import jax

from ruleset_analysis_tpu import cli as rcli
from ruleset_analysis_tpu import errors as rerrors
from ruleset_analysis_tpu.config import AnalysisConfig as JConfig
from ruleset_analysis_tpu.config import SketchConfig as JSketch
from ruleset_analysis_tpu.hostside import aclparse as raclparse
from ruleset_analysis_tpu.hostside import pack as rpack
from ruleset_analysis_tpu.parallel import mesh as rmesh
from ruleset_analysis_tpu.runtime import faults as rfaults
from ruleset_analysis_tpu.runtime import flightrec as rflightrec
from ruleset_analysis_tpu.runtime import obs as robs
from ruleset_analysis_tpu.runtime import retrypolicy as rretry
from ruleset_analysis_tpu.runtime import stream as rstream
from ruleset_analysis_tpu.runtime.report import VOLATILE_TOTALS
from ruleset_analysis_tpu_torch import cli, errors
from ruleset_analysis_tpu_torch.config import AnalysisConfig, SketchConfig
from ruleset_analysis_tpu_torch.hostside import aclparse, pack, wire
from ruleset_analysis_tpu_torch.runtime import faults, flightrec, obs, retrypolicy, stream

#: the reference chaos suites' dual-stack ruleset
CFG6 = """\
hostname fw1
access-list A extended permit tcp any host 10.0.0.5 eq 443
access-list A extended permit tcp any6 2001:db8:1::/48 eq 443
access-list A extended permit udp 2001:db8:2::/64 any6 eq 53
access-list A extended deny tcp any6 host 2001:db8::bad
access-list A extended permit ip any any
access-list B extended permit tcp any6 any6 range 8000 8100
access-group A in interface outside
"""

#: retry backoff of a few milliseconds at every run-path seam, the same
#: spec on both sides (the defaults sleep 50-100 ms a retry)
FAST_RETRY = "device_put=5/0.001,checkpoint.save=5/0.001,wire.read=4/0.001"

#: watchdog bound of the cases that inject a stall, which then aborts in
#: seconds (the other runs keep the default bound, so a loaded machine
#: never trips it)
STALL_SEC = 3.0


def mixed_lines(n: int, seed: int = 0, v6_share: float = 0.3) -> list[str]:
    """The reference chaos suites' mixed v4 + v6 syslog lines."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        acl = "A" if rng.random() < 0.8 else "B"
        if rng.random() < v6_share:
            src = f"2001:db8:2::{rng.randrange(1, 40):x}"
            dst = f"2001:db8:{rng.randrange(0, 4):x}:1::{rng.randrange(1, 99):x}"
            proto = rng.choice(["tcp", "udp"])
        else:
            src = f"10.1.{rng.randrange(256)}.{rng.randrange(1, 255)}"
            dst = "10.0.0.5" if rng.random() < 0.5 else "10.9.9.9"
            proto = "tcp"
        out.append(
            f"Jul 29 07:48:{i % 60:02d} fw1 : %ASA-6-106100: access-list {acl} "
            f"permitted {proto} inside/{src}({rng.randrange(1024, 60000)}) -> "
            f"outside/{dst}({rng.choice([443, 53, 8050, 80])}) "
            f"hit-cnt 1 first hit [0x0, 0x0]"
        )
    return out


def make_corpus(td, n_lines: int, seed: int) -> dict:
    """CFG6 packed by each package, ``n_lines`` mixed lines as text, and the
    port's ``.rawire`` of them (the reference's format: both read it)."""
    packed = pack.pack_rulesets([aclparse.parse_asa_config(CFG6, "fw1")])
    rpacked = rpack.pack_rulesets([raclparse.parse_asa_config(CFG6, "fw1")])
    text = str(td / "mix.log")
    with open(text, "w", encoding="utf-8") as f:
        f.write("\n".join(mixed_lines(n_lines, seed=seed)) + "\n")
    wirep = str(td / "mix.rawire")
    wire.convert_logs(packed, [text], wirep, batch_size=512, block_rows=512)
    prefix = str(td / "rules")
    pack.save_packed(packed, prefix)
    return {"packed": packed, "rpacked": rpacked, "text": text, "wire": wirep,
            "prefix": prefix}


def image(rep) -> dict:
    """A report without its volatile totals and its backend."""
    j = rep if isinstance(rep, dict) else json.loads(rep.to_json())
    j = json.loads(json.dumps(j))
    for k in VOLATILE_TOTALS + ("backend",):
        j["totals"].pop(k, None)
    return j


def reset_all() -> None:
    """Disarm both packages' faults, tracer, recorder and retry tables."""
    for f, o, fr, r in ((faults, obs, flightrec, retrypolicy),
                        (rfaults, robs, rflightrec, rretry)):
        f.disarm()
        o._reset_for_tests()
        fr._reset_for_tests()
        r._reset_for_tests()


class Side:
    """One package: its modules, a config maker and a stream runner."""

    def __init__(self, name: str):
        self.name = name
        port = name == "port"
        self.faults = faults if port else rfaults
        self.retry = retrypolicy if port else rretry
        self.obs = obs if port else robs
        self.flightrec = flightrec if port else rflightrec
        self.errors = errors if port else rerrors
        self.cli = cli if port else rcli

    def cfg(self, **kw):
        sketch = dict(cms_width=1 << 10, cms_depth=2, hll_p=6)
        base = dict(batch_size=512, retry_policy=FAST_RETRY)
        base.update(kw)
        if self.name == "port":
            return AnalysisConfig(sketch=SketchConfig(**sketch), device="cpu", **base)
        return JConfig(sketch=JSketch(**sketch), **base)

    def run(self, c: dict, inp: str, cfg, **kw):
        """``run_stream_wire`` or ``run_stream_file`` over the corpus."""
        if self.name == "port":
            packed, mod, extra = c["packed"], stream, {}
        else:
            packed, mod = c["rpacked"], rstream
            extra = {"mesh": rmesh.make_mesh(jax.devices()[:1])}
        if inp == "wire":
            return mod.run_stream_wire(packed, c["wire"], cfg, topk=5, **extra)
        return mod.run_stream_file(packed, c["text"], cfg, topk=5, **extra, **kw)

    def outcome(self, c: dict, inp: str, cfg, plan: str | None = None, **kw):
        """(image of the report, None) or (None, (error class, exit code)),
        with ``plan`` armed around the run."""
        armed = (self.faults.armed(self.faults.FaultPlan.parse(plan)) if plan
                 else contextlib.nullcontext())
        with armed:
            try:
                rep = self.run(c, inp, cfg, **kw)
            except self.errors.AnalysisError as e:
                return None, (type(e).__name__, self.errors.exit_code_for(e))
        return image(rep), None


PORT, REF = Side("port"), Side("ref")
BOTH = (PORT, REF)


def ref_one_device(monkeypatch) -> None:
    """The reference CLI on a one-device mesh (the suite fakes eight)."""
    make = rmesh.make_mesh
    monkeypatch.setattr(rmesh, "make_mesh",
                        lambda devices=None, *a, **k: make(jax.devices()[:1], *a, **k))
