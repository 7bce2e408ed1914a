"""The port's native C++ parser against the reference's and the Python parser.

The port builds its own copy of the parser (``ruleset_analysis_tpu_torch/
native/``) into ``build/native/``.  On the same files its batches must
equal, batch by batch and with tolerance 0, the reference's
``fastparse.batches_from_files`` and the port's own Python batcher:
out-direction bindings (two rows per line, batches closing early), IPv6
lines against a v4 ruleset, junk lines, CRLF line ends, a file without a
final newline, ``skip_lines``, SIMD dispatch on and off, one and several
parse threads.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ruleset_analysis_tpu.hostside import fastparse as rfast
from ruleset_analysis_tpu.hostside import pack as rpack
from ruleset_analysis_tpu_torch.errors import NativeParserUnavailable
from ruleset_analysis_tpu_torch.hostside import aclparse, fastparse, pack, synth
from ruleset_analysis_tpu_torch.hostside.pack import T_VALID
from ruleset_analysis_tpu_torch.runtime.stream import _iter_files, _TextSource
from tests._torch_refnative import ensure_reference_native

ROOT = Path(__file__).resolve().parent.parent

V6_LINE = (
    "Jul 29 07:48:01 fw1 : %ASA-6-106100: access-list ACL0 permitted tcp "
    "inside/2001:db8::{i:x}(1234) -> outside/2001:db8::2(80) hit-cnt 1 first hit [0x0, 0x0]"
)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    text = synth.synth_config(n_acls=3, rules_per_acl=12, seed=5, egress_acls=True)
    packed = pack.pack_rulesets([aclparse.parse_asa_config(text, "fw1")])
    lines = synth.render_syslog(packed, synth.synth_tuples(packed, 6000, seed=5), seed=5,
                                variety=0.4)
    rng = np.random.default_rng(5)
    junk = ["", "garbage", "Jul 29 07:48:01 fw1 : %ASA-6-106100: access-list", "x" * 5000]
    for i in rng.choice(len(lines), 300, replace=False):
        lines[i] = junk[i % len(junk)] if i % 3 else V6_LINE.format(i=i + 1)
    d = tmp_path_factory.mktemp("fastparse")
    pack.save_packed(packed, str(d / "fw1"))
    # CRLF line ends in the first file; the second has no final newline
    (d / "a.log").write_bytes("".join(ln + "\r\n" for ln in lines[:3500]).encode())
    (d / "b.log").write_bytes("\n".join(lines[3500:]).encode())
    return packed, [str(d / "a.log"), str(d / "b.log")], d


@pytest.fixture(scope="module")
def ref_native():
    """The reference's native parser, loaded in this process
    (``tests/_torch_refnative.py`` says why that takes a helper)."""
    return ensure_reference_native()


def _python_batches(packed, paths, b, skip):
    src = _TextSource(packed, _iter_files(paths))
    for batch, n in src.batches(skip, b):
        yield batch, n, src.packer.parsed, src.packer.skipped


@pytest.mark.parametrize("b", [256, 1000])
@pytest.mark.parametrize("skip", [0, 37])
@pytest.mark.parametrize("simd", [True, False])
@pytest.mark.parametrize("threads", ["1", "4"])
def test_native_batches_equal_reference_and_python(corpus, ref_native, monkeypatch, b, skip, simd,
                                                   threads):
    packed, paths, d = corpus
    monkeypatch.setenv("RA_PARSE_THREADS", threads)
    fastparse.set_simd(simd)
    try:
        mine = fastparse.NativePacker(packed)
        ref = rfast.NativePacker(rpack.load_packed(str(d / "fw1")))
        got = list(fastparse.batches_from_files(paths, mine, b, skip_lines=skip))
        want = list(rfast.batches_from_files(paths, ref, b, skip_lines=skip))
    finally:
        fastparse.set_simd(True)
    assert len(got) == len(want) > 5
    for (g, gn), (w, wn) in zip(got, want):
        assert gn == wn and g.dtype == np.uint32 and (g == w).all()
    assert (mine.parsed, mine.skipped) == (ref.parsed, ref.skipped)
    # the Python batcher: same boundaries, same rows; a batch of no rows
    # is None there and all-invalid here
    py = list(_python_batches(packed, paths, b, skip))
    assert [n for _, n in got] == [n for _, n, _, _ in py]
    for (g, _), (p, _, _, _) in zip(got, py):
        if p is None:
            assert not g[T_VALID].any()
        else:
            assert (g == p).all()
    assert (mine.parsed, mine.skipped) == py[-1][2:]
    assert mine.skipped >= 250 and any(n < b for _, n in got[:-1])  # early closes happened


def test_pack_lines_and_counters_equal_reference(corpus, ref_native):
    packed, paths, d = corpus
    lines = Path(paths[1]).read_text().split("\n")[:500]
    mine = fastparse.NativePacker(packed)
    ref = rfast.NativePacker(rpack.load_packed(str(d / "fw1")))
    assert (mine.pack_lines(lines) == ref.pack_lines(lines)).all()
    assert (mine.parsed, mine.skipped) == (ref.parsed, ref.skipped)
    mine.set_counts(7, 9)
    assert (mine.parsed, mine.skipped) == (7, 9)


def test_skip_past_the_end_is_refused(corpus):
    from ruleset_analysis_tpu_torch.errors import ResumeInputMismatch

    packed, paths, _ = corpus
    with pytest.raises(ResumeInputMismatch):
        list(fastparse.batches_from_files(paths, fastparse.NativePacker(packed), 512,
                                          skip_lines=10 ** 6))


def test_count_lines_in_file(corpus):
    _, paths, _ = corpus
    assert fastparse.count_lines_in_file(paths[0]) == 3500
    assert fastparse.count_lines_in_file(paths[1]) == rfast.count_lines_in_file(paths[1]) == 2500


def test_library_is_built_from_the_ports_sources_into_build_native():
    path = fastparse.build()
    assert path.parent == ROOT / "build" / "native"
    assert fastparse.NATIVE_DIR == ROOT / "ruleset_analysis_tpu_torch" / "native"
    assert path.exists() and path.name.startswith("_asaparse-")
    assert fastparse.build() == path  # an unchanged source is reused
    assert fastparse.simd_kind() in ("avx2", "neon", "scalar")
    assert 1 <= fastparse.default_parse_threads() <= 32


def test_makefile_flags_equal_the_builders():
    text = (fastparse.NATIVE_DIR / "Makefile").read_text()
    line = next(ln for ln in text.splitlines() if ln.startswith("CXXFLAGS"))
    assert tuple(line.split("=", 1)[1].split()) == fastparse.CXXFLAGS
    assert sorted(p.name for p in fastparse.NATIVE_DIR.iterdir()) == sorted(
        p.name for p in (ROOT / "ruleset_analysis_tpu" / "native").iterdir()
        if p.suffix not in (".o", ".so")
    )


def test_concurrent_first_builds_never_load_a_partial_library(tmp_path):
    """Four processes build into one empty directory at once: each loads a
    whole library, one file results, no temp directory is left."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from ruleset_analysis_tpu_torch.hostside import fastparse as f\n"
        "f.BUILD_DIR = Path(sys.argv[1])\n"
        "p = f.build()\n"
        "print(p, f._load().asa_count_nl(b'a\\nb\\n', 4))\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    assert len({o for o, _ in outs}) == 1 and outs[0][0].split()[1] == "2"
    assert sorted(p.name for p in tmp_path.iterdir() if not p.name.startswith(".")) == [
        Path(outs[0][0].split()[0]).name
    ]


def test_no_toolchain_raises_and_never_switches_to_python(corpus, monkeypatch, tmp_path, capsys):
    from ruleset_analysis_tpu_torch import cli
    from ruleset_analysis_tpu_torch.config import AnalysisConfig
    from ruleset_analysis_tpu_torch.runtime.stream import run_stream_file

    packed, paths, d = corpus
    monkeypatch.setattr(fastparse, "_compiler", lambda: None)
    fastparse._load_locked.cache_clear()
    try:
        assert not fastparse.available()
        with pytest.raises(NativeParserUnavailable, match="no C\\+\\+ compiler"):
            fastparse.NativePacker(packed)
        cfg = AnalysisConfig(batch_size=512, device="cpu")
        with pytest.raises(NativeParserUnavailable):
            run_stream_file(packed, paths, cfg, native=True)
        args = ["run", "--ruleset", str(d / "fw1"), "--logs", *paths, "--device", "cpu",
                "--json"]
        capsys.readouterr()
        assert cli.main(args + ["--native-parse"]) == 5  # the reference's feed-failure code
        assert "native parser unavailable" in capsys.readouterr().err
        # native=None keeps its meaning: the C++ parser when it builds,
        # else the Python one
        auto = run_stream_file(packed, paths, cfg)
        assert auto.totals["lines_total"] == 6000
    finally:
        monkeypatch.undo()
        fastparse._load_locked.cache_clear()
    assert fastparse.available()


def test_native_coalesce_equals_numpy():
    rng = np.random.default_rng(1)
    mat = rng.integers(0, 4, size=(5, 3000)).astype(np.uint32)
    mat[-1] = rng.integers(0, 3, size=3000)
    got = fastparse.native_coalesce(mat, want_first=True)
    want = pack._np_coalesce(mat, want_first=True)
    assert (got[0] == want[0]).all() and (got[1] == want[1]).all()
    assert int(got[0][-1].sum()) == int(mat[-1].sum())


def test_parse_threads_env_override(monkeypatch):
    monkeypatch.setenv("RA_PARSE_THREADS", "3")
    assert fastparse.default_parse_threads() == 3
    monkeypatch.setenv("RA_PARSE_THREADS", "junk")
    assert fastparse.default_parse_threads() == fastparse.host_workers("UNSET_VAR_X", 32)
    assert os.environ["RA_PARSE_THREADS"] == "junk"
