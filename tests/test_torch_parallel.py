"""The port's sharded step and mesh runs against the reference's, on the CPU.

Mirrors tests/test_parallel.py.  The port's mesh is ``[cpu] * n`` (n
shards sharing the CPU's register replica), the reference's
``make_mesh(jax.devices()[:n])`` over the conftest's fake devices, for n
in 2, 4 and 8:

- the sharded step (scan, fused, a weighted batch, v6 and stacked
  batches; three chunks, the middle one deferred by ``topk_every=2``)
  gives the reference's registers and its ``[n * k]`` candidates, chunk
  by chunk, on the flat mesh and on the hybrid one (``dcn=2``);
- the same holds where the shards alternate between two distinct
  devices (``[cpu, cpu:0] * (n/2)``: two register replicas, merged by
  sums and copies between them, as on a host of several cards);
- the registers do not depend on how lines fall across shards, and the
  counts are the oracle's;
- a merged counts delta and talker delta past 2^32 wrap as the
  reference's u32 ``psum`` does (u32 weights in a weighted batch);
- ``run_stream``/``run_stream_file``/``run_stream_wire`` on a mesh give
  the reference's report on the same mesh, over text, native text, plain
  and weighted wire, coalescing, the ring feeder, the stacked layout and
  a dual-stack corpus;
- a snapshot either package writes on a two-shard mesh resumes in the
  other; one of another width is refused, exit 4 through either CLI.

The port's fused route is held to the reference's default step (the same
registers and candidates by construction; the reference's ``pallas_fused``
would run its Pallas kernel interpreted).  Tolerance 0 throughout.
"""

import functools
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from ruleset_analysis_tpu import cli as rcli  # noqa: E402
from ruleset_analysis_tpu.config import AnalysisConfig as JConfig  # noqa: E402
from ruleset_analysis_tpu.config import SketchConfig as JSketch  # noqa: E402
from ruleset_analysis_tpu.hostside import pack as rpack  # noqa: E402
from ruleset_analysis_tpu.models import pipeline as jpipe  # noqa: E402
from ruleset_analysis_tpu.parallel import mesh as rmesh  # noqa: E402
from ruleset_analysis_tpu.parallel import step as rstep  # noqa: E402
from ruleset_analysis_tpu.runtime import stream as rstream  # noqa: E402
from ruleset_analysis_tpu.runtime.report import VOLATILE_TOTALS  # noqa: E402
from ruleset_analysis_tpu_torch import cli  # noqa: E402
from ruleset_analysis_tpu_torch.config import AnalysisConfig, SketchConfig  # noqa: E402
from ruleset_analysis_tpu_torch.errors import AnalysisError, CheckpointMismatch  # noqa: E402
from ruleset_analysis_tpu_torch.hostside import aclparse, oracle, pack, synth, wire  # noqa: E402
from ruleset_analysis_tpu_torch.hostside.pack import T_VALID, TUPLE_COLS  # noqa: E402
from ruleset_analysis_tpu_torch.models import pipeline  # noqa: E402
from ruleset_analysis_tpu_torch.ops import reg_tail  # noqa: E402
from ruleset_analysis_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from ruleset_analysis_tpu_torch.parallel import step as step_lib  # noqa: E402
from ruleset_analysis_tpu_torch.runtime import stream  # noqa: E402
from tests._torch_refnative import ensure_reference_native  # noqa: E402

CPU = torch.device("cpu")
#: the CPU under another name: a second register replica in one mesh
CPU_0 = torch.device("cpu", 0)
SKETCH = dict(cms_width=1 << 10, cms_depth=4, hll_p=6)
B = 1024
CHUNKS = 3
REGISTERS = ("counts_lo", "counts_hi", "cms", "hll", "talk_cms")
CANDS = ("cand_acl", "cand_src", "cand_est")
KINDS = ("scan", "fused", "weighted", "v6", "stacked")
WIDTHS = (2, 4, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more, and
    the parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_devices():
    devs = jax.devices("cpu")
    assert len(devs) == 8, "conftest must provide 8 fake CPU devices"
    return devs


def _cfg(**kw):
    return AnalysisConfig(batch_size=B, sketch=SketchConfig(**SKETCH, topk_every=2),
                          device="cpu", **kw)


def _jcfg(**kw):
    return JConfig(batch_size=B, sketch=JSketch(**SKETCH, topk_every=2), **kw)


@functools.lru_cache(maxsize=None)
def _ruleset(v6: bool):
    text = synth.synth_config(n_acls=3, rules_per_acl=12, seed=31,
                              v6_fraction=0.4 if v6 else 0.0)
    packed = pack.pack_rulesets([aclparse.parse_asa_config(text, "fw1")])
    from ruleset_analysis_tpu.hostside import aclparse as raclparse

    rpacked = rpack.pack_rulesets([raclparse.parse_asa_config(text, "fw1")])
    return packed, rpacked


def _weights(n: int, seed: int) -> np.ndarray:
    """u32 weights near 2^30: a key's merged delta passes 2^32."""
    return np.random.default_rng(seed).integers(1 << 29, 1 << 31, size=n).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _batches(kind: str) -> tuple:
    """The CHUNKS host batches of ``kind``, as both steps take them."""
    packed, _ = _ruleset(kind == "v6")
    out = []
    for c in range(CHUNKS):
        seed = 31 + c
        if kind == "v6":
            out.append(np.ascontiguousarray(synth.synth_tuples6(packed, B, seed=seed).T))
        elif kind == "stacked":
            # a grouped batch [G, TUPLE_COLS, lane] with lane = B / G
            tup = synth.synth_tuples(packed, 4 * B, seed=seed)
            gbuf = pack.GroupBuffer(packed.n_acls, 128)
            grouped = gbuf.add(tup)
            out.append(grouped[0] if grouped else gbuf.flush()[0])
        else:
            tup = np.ascontiguousarray(synth.synth_tuples(packed, B, seed=seed).T)
            if kind == "weighted":
                tup[T_VALID] = np.where(tup[T_VALID] > 0, _weights(B, seed), 0)
                out.append(pack.compact_batch_w(tup))
            else:
                out.append(tup)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _reference(kind: str, n: int):
    """Registers and per-chunk candidates of the reference's step on n devices."""
    packed, rpacked = _ruleset(kind == "v6")
    mesh = rmesh.make_mesh(cpu_devices()[:n])
    jcfg = _jcfg()
    state = jpipe.init_state(rpacked.n_keys, jcfg)
    if kind == "v6":
        step = rstep.make_parallel_step6(mesh, jcfg, rpacked.n_keys)
        rules = jpipe.ship_ruleset6(rpacked)
    elif kind == "stacked":
        step = rstep.make_parallel_step_stacked(mesh, jcfg, rpacked.n_keys)
        rules = jpipe.ship_ruleset_stacked(rpacked)
    else:
        step = rstep.make_parallel_step(mesh, jcfg, rpacked.n_keys)
        rules = jpipe.ship_ruleset(rpacked)
    cands = []
    for salt, b in enumerate(_batches(kind)):
        if kind == "stacked":
            batch = rmesh.shard_grouped(mesh, rpack.compact_grouped(b))
        else:
            batch = rmesh.shard_batch(mesh, b)
        state, out = step(state, rules, batch, salt)
        cands.append({f: np.asarray(getattr(out, f)) for f in CANDS})
    regs = {f: np.asarray(getattr(state, f)) for f in REGISTERS}
    return regs, cands


def _port(kind: str, mesh: mesh_lib.Mesh):
    packed, _ = _ruleset(kind == "v6")
    cfg = _cfg(match_impl="fused" if kind == "fused" else "scan")
    state = step_lib.init_state(packed.n_keys, cfg, mesh)
    if kind == "v6":
        step = step_lib.make_parallel_step6(mesh, cfg, packed.n_keys)
        rules = step_lib.ship6(packed, mesh)
    else:
        step = step_lib.make_parallel_step(mesh, cfg, packed.n_keys)
        rules = step_lib.ship(packed, mesh)
    cands = []
    for salt, b in enumerate(_batches(kind)):
        shards = (mesh_lib.shard_grouped(mesh, b, False) if kind == "stacked"
                  else mesh_lib.shard_batch(mesh, b))
        state, out = step(state, rules, [s.use() for s in shards], salt)
        cands.append({f: getattr(out, f).numpy().astype(np.uint32) for f in CANDS})
    regs = pipeline.state_to_numpy(state[0])
    assert len(state) == len(mesh.local_devices)
    for r, replica in enumerate(state[1:], 1):  # every replica holds the merged registers
        other = pipeline.state_to_numpy(replica)
        for f in REGISTERS:
            np.testing.assert_array_equal(other[f], regs[f], err_msg=f"replica {r}: {f}")
    return regs, cands


def _assert_same(got, want, what):
    g_regs, g_cands = got
    w_regs, w_cands = want
    for f in REGISTERS:
        np.testing.assert_array_equal(g_regs[f], w_regs[f], err_msg=f"{what}: {f}")
    assert len(g_cands) == len(w_cands)
    for c, (g, w) in enumerate(zip(g_cands, w_cands)):
        for f in CANDS:
            np.testing.assert_array_equal(g[f], w[f], err_msg=f"{what}: chunk {c} {f}")


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_step_equals_the_references_on_the_same_mesh(kind, n):
    got = _port(kind, mesh_lib.make_mesh([CPU] * n))
    want = _reference(kind, n)
    _assert_same(got, want, f"{kind} x{n}")
    b0 = _batches(kind)[0]
    width = b0.shape[0] * b0.shape[-1] if kind == "stacked" else B  # G * lane lines
    k = min(SketchConfig().topk_chunk_candidates, width // n)
    assert got[1][0]["cand_acl"].shape == (n * k,)
    assert not got[1][1]["cand_est"].any()  # the deferred chunk selects nothing


@pytest.mark.parametrize("n", (4, 8))
@pytest.mark.parametrize("kind", KINDS)
def test_hybrid_mesh_equals_the_flat_one(kind, n):
    mesh = mesh_lib.make_mesh([CPU] * n, topology="hybrid", dcn=2)
    assert mesh.axis_names == (mesh_lib.DCN_AXIS, "data")
    assert mesh.shape == {"dcn": 2, "data": n // 2}
    assert mesh_lib.data_extent(mesh) == n
    _assert_same(_port(kind, mesh), _reference(kind, n), f"hybrid {kind} x{n}")


def test_one_shard_mesh_is_the_one_device_step():
    """A one-device mesh runs pipeline.analysis_step as it stands."""
    got = _port("scan", mesh_lib.make_mesh([CPU]))
    want = _reference("scan", 1)
    _assert_same(got, want, "x1")


def _replicas(n: int, **kw) -> mesh_lib.Mesh:
    """n shards alternating between two CPU devices: two register replicas
    that merge by sums and copies between them, as between two cards."""
    mesh = mesh_lib.make_mesh([CPU, CPU_0] * (n // 2), **kw)
    assert mesh.local_devices == (CPU, CPU_0)
    assert mesh.replica == (0, 1) * (n // 2)
    return mesh


@pytest.mark.parametrize("topology", ("flat", "hybrid"))
@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_distinct_replicas_equal_the_references(kind, n, topology):
    """A mesh of two distinct devices (the default run on a multi-GPU host
    holds one replica a card): the cross-replica sums, the HLL max and its
    copies, and the candidates in mesh order give the reference's on n
    devices, the weighted case's wrapping u32 deltas included."""
    mesh = _replicas(n, topology=topology, dcn=2 if topology == "hybrid" else 0)
    assert mesh_lib.make_rings(mesh, 2) is None  # no CUDA device: no pinned ring
    _assert_same(_port(kind, mesh), _reference(kind, n), f"{topology} {kind} x{n}, 2 replicas")


def test_merged_u32_deltas_wrap_as_the_references():
    """A key's counts delta, summed over 8 shards, passes 2^32: the merge
    wraps it (and the talker delta) as the reference's u32 psum does."""
    packed, _ = _ruleset(False)
    b = _batches("weighted")[0]
    t = torch.from_numpy(b.view(np.int32))
    m = pipeline.match_lines(pipeline.ship_ruleset(packed, CPU), t, n_keys=packed.n_keys)
    keys = reg_tail.line_keys(m.row, m.acl, m.key_k, m.n_rows).numpy()
    w = m.valid.numpy().view(np.uint32).astype(np.float64)
    ok = keys < packed.n_keys
    per_key = np.bincount(keys[ok], weights=w[ok], minlength=packed.n_keys)
    assert per_key.max() > 2 ** 33  # wraps more than once, over shards of ~2^32
    got = _port("weighted", mesh_lib.make_mesh([CPU] * 8))
    _assert_same(got, _reference("weighted", 8), "weighted x8")
    # registers do not depend on the mesh width, wrapping included
    one = _port("weighted", mesh_lib.make_mesh([CPU]))
    for f in REGISTERS:
        np.testing.assert_array_equal(got[0][f], one[0][f], err_msg=f)


@pytest.mark.parametrize("n", WIDTHS)
def test_shard_order_invariance(n):
    """Permuting lines across shards changes no merged register."""
    packed, _ = _ruleset(False)
    mesh = mesh_lib.make_mesh([CPU] * n)
    cfg = _cfg()
    b = _batches("scan")[0]
    perm = np.random.default_rng(0).permutation(B)
    regs = []
    for batch in (b, np.ascontiguousarray(b[:, perm])):
        step = step_lib.make_parallel_step(mesh, cfg, packed.n_keys)
        state = step_lib.init_state(packed.n_keys, cfg, mesh)
        state, _ = step(state, step_lib.ship(packed, mesh),
                        [s.use() for s in mesh_lib.shard_batch(mesh, batch)])
        regs.append(pipeline.state_to_numpy(state[0]))
    for f in REGISTERS:
        np.testing.assert_array_equal(regs[0][f], regs[1][f], err_msg=f)


def test_sharded_counts_equal_the_oracle():
    text = synth.synth_config(n_acls=3, rules_per_acl=12, seed=31)
    rs = aclparse.parse_asa_config(text, "fw1")
    packed, _ = _ruleset(False)
    lines = synth.render_syslog(packed, np.ascontiguousarray(_batches("scan")[0].T), seed=31)
    res = oracle.Oracle([rs]).consume(lines)
    mesh = mesh_lib.make_mesh([CPU] * 8)
    cfg = _cfg()
    step = step_lib.make_parallel_step(mesh, cfg, packed.n_keys)
    state = step_lib.init_state(packed.n_keys, cfg, mesh)
    state, _ = step(state, step_lib.ship(packed, mesh),
                    [s.use() for s in mesh_lib.shard_batch(mesh, _batches("scan")[0])])
    regs = pipeline.state_to_numpy(state[0])
    per_key = regs["counts_lo"].astype(np.uint64) + (regs["counts_hi"].astype(np.uint64) << 32)
    got = {(m.firewall, m.acl, m.index): int(per_key[i])
           for i, m in enumerate(packed.key_meta) if per_key[i]}
    assert got == dict(res.hits)


# ---------------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------------


def test_mesh_refusals_are_the_references():
    with pytest.raises(AnalysisError, match="unknown mesh topology"):
        mesh_lib.make_mesh([CPU] * 2, topology="ring")
    with pytest.raises(AnalysisError, match="outer \\(dcn\\) extent >= 2"):
        mesh_lib.make_mesh([CPU] * 4, topology="hybrid", dcn=1)
    with pytest.raises(AnalysisError, match="do not divide into 3 dcn groups"):
        mesh_lib.make_mesh([CPU] * 4, topology="hybrid", dcn=3)
    for kw in (dict(mesh_shape="torus"), dict(mesh_dcn=-1), dict(mesh_dcn=2)):
        with pytest.raises(ValueError):
            AnalysisConfig(**kw)
        with pytest.raises(ValueError):
            JConfig(**kw)
    with pytest.raises(ValueError, match="does not split"):
        mesh_lib.shard_batch(mesh_lib.make_mesh([CPU] * 4), np.zeros((7, 10), np.uint32))


@pytest.mark.parametrize("n,topology,dcn", [
    (n, t, d) for n in WIDTHS for t, d in (("flat", 0), ("hybrid", 0), ("hybrid", 2),
                                          ("hybrid", 4)) if n % max(d, 2) == 0
])
def test_mesh_geometry_equals_the_references(n, topology, dcn):
    mine = mesh_lib.make_mesh([CPU] * n, topology=topology, dcn=dcn)
    ref = rmesh.make_mesh(cpu_devices()[:n], topology=topology, dcn=dcn)
    assert mine.axis_names == tuple(ref.axis_names)
    assert mine.shape == dict(ref.shape)
    assert mesh_lib.data_extent(mine) == rmesh.data_extent(ref) == n
    for bs in (1, 7, 64, 1000, 1 << 16):
        assert mesh_lib.pad_batch_size(bs, mine) == rmesh.pad_batch_size(bs, ref)


@pytest.mark.parametrize("n", WIDTHS)
def test_shard_batch_slices_in_mesh_order(n):
    """Shard i holds columns [i*B/n, (i+1)*B/n), as the reference's device i."""
    b = _batches("scan")[0]
    mine = mesh_lib.shard_batch(mesh_lib.make_mesh([CPU] * n), b)
    ref = rmesh.shard_batch(rmesh.make_mesh(cpu_devices()[:n]), b)
    by_dev = {s.device: np.asarray(s.data) for s in ref.addressable_shards}
    for i, (s, dev) in enumerate(zip(mine, cpu_devices()[:n])):
        np.testing.assert_array_equal(s.use().numpy().view(np.uint32), by_dev[dev], err_msg=str(i))


# ---------------------------------------------------------------------------
# run_stream on a mesh
# ---------------------------------------------------------------------------


def _strip(rep) -> dict:
    obj = json.loads(rep.to_json())
    for k in VOLATILE_TOTALS + ("backend",):
        obj["totals"].pop(k, None)
    return obj


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """A v4 corpus (text, plain and weighted wire) and a dual-stack one."""
    td = tmp_path_factory.mktemp("mesh_runs")
    out = {}
    for name, v6 in (("v4", 0.0), ("v6", 0.3)):
        text = synth.synth_config(n_acls=3, rules_per_acl=12, seed=7, v6_fraction=v6)
        packed = pack.pack_rulesets([aclparse.parse_asa_config(text, "fw1")])
        prefix = str(td / f"{name}-packed")
        pack.save_packed(packed, prefix)
        log = str(td / f"{name}.log")
        synth.synth_syslog_file(packed, log, 3000, seed=9, v6_fraction=v6)
        wire.convert_logs(packed, [log], str(td / f"{name}.rawire"), native=False,
                          block_rows=256)
        wire.convert_logs(packed, [log], str(td / f"{name}-w.rawire"), native=False,
                          block_rows=256, coalesce=True)
        out[name] = (prefix, log)
    return td, out


RUNS = {
    # name: (corpus, entry, config overrides)
    "text": ("v4", "lines", {}),
    "native": ("v4", "file", {}),
    "wire": ("v4", "wire", {}),
    "wire-weighted": ("v4", "wire-w", {}),
    "coalesce": ("v4", "lines", {"coalesce": "on"}),
    "ring": ("v4", "ring", {}),
    "stacked": ("v4", "lines", {"layout": "stacked"}),
    "fused": ("v4", "lines", {"match_impl": "fused"}),
    "dual-stack": ("v6", "lines", {}),
    "dual-stack-wire": ("v6", "wire", {}),
}


def _runs(td, corp, name, n, mesh=None):
    cname, entry, over = RUNS[name]
    prefix, log = corp[cname]
    packed = pack.load_packed(prefix)
    rpacked = rpack.load_packed(prefix)
    cfg = AnalysisConfig(batch_size=300, sketch=SketchConfig(**SKETCH), device="cpu", **over)
    jover = dict(over)
    if jover.get("match_impl") == "fused":
        jover.pop("match_impl")  # the reference's default step: the same answer
    jcfg = JConfig(batch_size=300, sketch=JSketch(**SKETCH), **jover)
    mesh = mesh or mesh_lib.make_mesh([CPU] * n)
    rm = rmesh.make_mesh(cpu_devices()[:n])
    lines = open(log, encoding="utf-8").read().splitlines()
    if entry == "lines":
        mine = stream.run_stream(packed, iter(lines), cfg, topk=50, mesh=mesh)
        ref = rstream.run_stream(rpacked, iter(lines), jcfg, topk=50, mesh=rm)
    elif entry in ("file", "ring"):
        ensure_reference_native()
        kw = dict(feed_workers=2, feed_mode="ring") if entry == "ring" else {}
        mine = stream.run_stream_file(packed, [log], cfg, topk=50, mesh=mesh, **kw)
        ref = rstream.run_stream_file(rpacked, [log], jcfg, topk=50, mesh=rm, **kw)
    else:
        w = str(td / (f"{cname}-w.rawire" if entry == "wire-w" else f"{cname}.rawire"))
        mine = stream.run_stream_wire(packed, [w], cfg, topk=50, mesh=mesh)
        ref = rstream.run_stream_wire(rpacked, [w], jcfg, topk=50, mesh=rm)
    return mine, ref


@pytest.mark.parametrize("n", (2, 8))
@pytest.mark.parametrize("name", list(RUNS))
def test_run_on_a_mesh_equals_the_references_report(corpora, name, n):
    td, corp = corpora
    mine, ref = _runs(td, corp, name, n)
    assert _strip(mine) == _strip(ref)


@pytest.mark.parametrize("name", ["text", "wire-weighted", "ring", "stacked", "dual-stack-wire"])
def test_run_on_distinct_replicas_equals_the_references_report(corpora, name):
    """The run loop over two register replicas (the default mesh of a
    multi-GPU host): prefetch, the ring feeder's per-shard views, grouped
    batches and the v6 side path, each to its shard's device."""
    td, corp = corpora
    mine, ref = _runs(td, corp, name, 4, mesh=_replicas(4))
    assert _strip(mine) == _strip(ref)


# ---------------------------------------------------------------------------
# snapshots across the packages, n = 2
# ---------------------------------------------------------------------------


def test_snapshots_cross_resume_between_the_packages_on_two_shards(corpora, tmp_path):
    td, corp = corpora
    prefix, log = corp["v4"]
    packed = pack.load_packed(prefix)
    rpacked = rpack.load_packed(prefix)
    lines = open(log, encoding="utf-8").read().splitlines()
    mesh = mesh_lib.make_mesh([CPU] * 2)
    rm = rmesh.make_mesh(cpu_devices()[:2])

    def cfg(ck, resume=False):
        return AnalysisConfig(batch_size=300, sketch=SketchConfig(**SKETCH), device="cpu",
                              checkpoint_every_chunks=2, checkpoint_dir=str(ck), resume=resume)

    def jcfg(ck, resume=False):
        return JConfig(batch_size=300, sketch=JSketch(**SKETCH), checkpoint_every_chunks=2,
                       checkpoint_dir=str(ck), resume=resume)

    whole = _strip(stream.run_stream(packed, iter(lines), cfg(tmp_path / "u"), topk=50,
                                     mesh=mesh))
    # the port writes, the reference resumes
    stream.run_stream(packed, iter(lines), cfg(tmp_path / "a"), topk=50, mesh=mesh,
                      max_chunks=5)
    got = rstream.run_stream(rpacked, iter(lines), jcfg(tmp_path / "a", True), topk=50, mesh=rm)
    assert _strip(got) == whole
    # the reference writes, the port resumes
    rstream.run_stream(rpacked, iter(lines), jcfg(tmp_path / "b"), topk=50, mesh=rm,
                       max_chunks=5)
    got = stream.run_stream(packed, iter(lines), cfg(tmp_path / "b", True), topk=50,
                            mesh=mesh)
    assert _strip(got) == whole
    # a snapshot of another width is refused
    stream.run_stream(packed, iter(lines), cfg(tmp_path / "c"), topk=50, mesh=mesh,
                      max_chunks=5)
    with pytest.raises(CheckpointMismatch):
        stream.run_stream(packed, iter(lines), cfg(tmp_path / "c", True), topk=50,
                          mesh=mesh_lib.make_mesh([CPU] * 4))


def test_a_snapshot_of_another_width_exits_4_in_either_cli(corpora, tmp_path, capsys):
    """The port's CLI runs on one CPU device and the reference's on the
    conftest's eight: a two-shard snapshot resumes in neither."""
    td, corp = corpora
    prefix, log = corp["v4"]
    packed = pack.load_packed(prefix)
    ck = tmp_path / "ck"
    cfg = AnalysisConfig(batch_size=300, sketch=SketchConfig(**SKETCH), device="cpu",
                         checkpoint_every_chunks=2, checkpoint_dir=str(ck))
    stream.run_stream_file(packed, [log], cfg, native=False,
                           mesh=mesh_lib.make_mesh([CPU] * 2), max_chunks=5)
    assert os.path.exists(ck / "LATEST")
    args = ["run", "--ruleset", prefix, "--logs", log, "--batch-size", "300",
            "--cms-width", "1024", "--hll-p", "6", "--checkpoint-every", "2",
            "--checkpoint-dir", str(ck), "--resume", "--no-native-parse", "--json"]
    assert cli.main([*args, "--device", "cpu"]) == 4
    assert rcli.main(args) == 4
    capsys.readouterr()
