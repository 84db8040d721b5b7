"""The port's CLIs (``seqalign_tpu_torch.cli``): the golden fixture battery
of ``tests/golden/cli`` byte for byte on the CPU (``SEQALIGN_DEVICE=cpu``),
the aligning cases again with every batch on the port's device path (its
plain kernels, ``SEQALIGN_FORCE=device``), a generated FASTA through both
packages' NW and SW CLIs, the device selector, and the port's counterparts
of ``tests/test_observability.py`` (stats, skip/resume, the profiler
trace)."""

import contextlib
import io
import json
import os
import re
import sys

import numpy as np
import pytest

from seqalign_tpu.cli import needleman_wunsch as jax_nw
from seqalign_tpu.cli import smith_waterman as jax_sw
from seqalign_tpu_torch.cli import lcs, needleman_wunsch, smith_waterman
from seqalign_tpu_torch.utils.metrics import RunStats, timed

CLI_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                       "cli")
INP = os.path.join(CLI_DIR, "inputs")
with open(os.path.join(CLI_DIR, "manifest.json")) as fh:
    MANIFEST = json.load(fh)
ALIGNING = [c for c in MANIFEST if c["rc"] == 0]
NOTHING_TO_ALIGN = ("nw_file_empty", "sw_err_empty_seq")
MAINS = {"needleman_wunsch": needleman_wunsch.main,
         "smith_waterman": smith_waterman.main, "lcs": lcs.main}
# the usage footer's __DATE__/__TIME__ (alignment_cmdline.c:165), as
# tests/test_cli_golden.py normalises it
STAMP = re.compile(r"\(compiled: [A-Z][a-z]{2} [ \d]\d \d{4} \d\d:\d\d:\d\d\)")


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    for k in ("SEQALIGN_FORCE", "SEQALIGN_STATS", "SEQALIGN_SKIP_PAIRS",
              "SEQALIGN_RESUME_FILE", "SEQALIGN_TRACE_DIR"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SEQALIGN_DEVICE", "cpu")


def _run(main, argv, stdin=None):
    out, err = io.StringIO(), io.StringIO()
    old = sys.stdin
    rc = 0
    try:
        if stdin is not None:
            sys.stdin = io.StringIO(stdin)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                r = main(argv)
                rc = 0 if r is None else int(r)
            except SystemExit as e:
                rc = 0 if e.code is None else int(e.code)
    finally:
        sys.stdin = old
    return rc, out.getvalue(), err.getvalue()


def _golden(case):
    args = [a.replace("@INP", INP) for a in case["args"]]
    rc, out, err = _run(MAINS[case["tool"]], [case["tool"]] + args,
                        case["stdin"])
    with open(os.path.join(CLI_DIR, case["id"] + ".out")) as fh:
        want_out = fh.read()
    with open(os.path.join(CLI_DIR, case["id"] + ".err")) as fh:
        want_err = fh.read()
    norm = "(compiled: STAMP)"
    assert STAMP.sub(norm, out) == STAMP.sub(norm, want_out), case["id"]
    assert err == want_err, case["id"]
    assert rc == case["rc"], case["id"]


@pytest.mark.parametrize("case", MANIFEST, ids=[c["id"] for c in MANIFEST])
def test_cli_matches_reference(case):
    _golden(case)


@pytest.mark.parametrize("case", ALIGNING, ids=[c["id"] for c in ALIGNING])
def test_cli_matches_reference_on_device_path(case, monkeypatch):
    from seqalign_tpu_torch.ops import kernels

    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    calls = []
    for name in ("nw_fill_dirs_plain", "nw_fill_gab_plain",
                 "sw_fill_dirs_plain", "sw_fill_gab_plain"):
        fn = getattr(kernels, name)
        monkeypatch.setattr(kernels, name,
                            lambda *a, _f=fn, _n=name: calls.append(_n)
                            or _f(*a))
    _golden(case)
    # every pair went through the device path's fills, the matrix dump
    # through the GAB fills (two cases hold no pair to align)
    assert bool(calls) != (case["id"] in NOTHING_TO_ALIGN), case["id"]
    gab = "--printmatrices" in case["args"]
    assert all(c.endswith("gab_plain") == gab for c in calls), case["id"]


def _fasta(tmp_path, n, seed, lo=20, hi=120):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"acgtACGT", np.uint8)
    lines = []
    for i in range(2 * n):
        k = int(rng.integers(lo, hi + 1))
        lines += [f">s{i}", bytes(alpha[rng.integers(0, 8, k)]).decode()]
    path = tmp_path / "pairs.fa"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("tool", ["nw", "sw"])
def test_generated_fasta_equals_jax_cli(tool, tmp_path):
    """48 pairs (past the host path's 32-pair limit, so the port's device
    path and its plain kernels) through both packages' CLIs."""
    fa = _fasta(tmp_path, 48, 48)
    ours, theirs = ((needleman_wunsch.main, jax_nw.main) if tool == "nw"
                    else (smith_waterman.main, jax_sw.main))
    args = (["--printscores", "--pretty"] if tool == "nw"
            else ["--maxhits", "3"]) + ["--file", fa]
    got = _run(ours, ["prog"] + args)
    want = _run(theirs, ["prog"] + args)
    assert got == want
    assert got[0] == 0 and got[1].count("\n") > 48 * 3


@pytest.mark.parametrize("value", ["bogus", "tpu", "cuda:0"])
def test_device_selector_rejects_other_values(value, monkeypatch):
    monkeypatch.setenv("SEQALIGN_DEVICE", value)
    for main in MAINS.values():
        rc, out, err = _run(main, ["prog", "ACGT", "ACAT"][:3 if main is not
                                                           lcs.main else 2])
        assert rc == 1 and out == ""
        assert err == ("Error: SEQALIGN_DEVICE must be 'cuda' or 'cpu', not "
                       f"'{value}'\n")


def test_device_selector_defaults_to_the_gpu(monkeypatch):
    """Unset, the CLI aligns on the GPU, and without one it stops: nothing
    falls back to the CPU."""
    import torch

    monkeypatch.delenv("SEQALIGN_DEVICE")
    if torch.cuda.is_available():
        from seqalign_tpu_torch.cli._common import cli_device
        assert cli_device().type == "cuda"
        return
    rc, out, err = _run(needleman_wunsch.main, ["prog", "ACGT", "ACAT"])
    assert rc == 1 and out == "" and err.startswith("Error: no CUDA device")


def test_cli_leaves_no_jax_loaded(tmp_path):
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    fa = _fasta(tmp_path, 40, 7)
    code = (
        "import sys, io, contextlib\n"
        "from seqalign_tpu_torch.cli import needleman_wunsch, smith_waterman"
        ", lcs\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        f"    assert needleman_wunsch.main(['nw', '--printmatrices', "
        f"'ACGTT', 'AGT']) == 0\n"
        f"    assert smith_waterman.main(['sw', '--file', {fa!r}]) == 0\n"
        "    assert lcs.main(['lcs', 'acgtacgt']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'seqalign_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, SEQALIGN_DEVICE="cpu", SEQALIGN_FORCE="device")
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


# the port's counterparts of tests/test_observability.py


def test_runstats_counters():
    rs = RunStats()
    rs.add([10, 20], [30, 5], 2.0)
    assert rs.pairs == 2
    assert rs.cells == 10 * 30 + 20 * 5
    assert rs.gcups == pytest.approx(rs.cells / 2.0 / 1e9)
    assert rs.pairs_per_s == pytest.approx(1.0)
    s = rs.summary()
    assert "pairs=2" in s and "cells=400" in s


def test_timed_accumulates():
    rs = RunStats()
    with timed(rs, [4], [5]):
        pass
    assert rs.pairs == 1 and rs.cells == 20 and rs.seconds > 0


def test_nw_cli_stats_line(monkeypatch):
    monkeypatch.setenv("SEQALIGN_STATS", "1")
    rc, out, err = _run(needleman_wunsch.main, ["prog", "ACGT", "ACAT"])
    assert rc == 0
    assert "seqalign stats: pairs=1 cells=16" in err
    assert "stats" not in out


def test_sw_cli_stats_line(monkeypatch, tmp_path):
    fa = tmp_path / "p.fa"
    fa.write_text(">a\nACGTACGT\n>b\nCGTA\n>c\nTTTT\n>d\nTATT\n")
    monkeypatch.setenv("SEQALIGN_STATS", "1")
    rc, out, err = _run(smith_waterman.main, ["prog", "--file", str(fa)])
    assert rc == 0
    assert "seqalign stats: pairs=2" in err


def test_lcs_cli_stats_line(monkeypatch):
    monkeypatch.setenv("SEQALIGN_STATS", "1")
    rc, out, err = _run(lcs.main, ["prog", "abcabc"])
    assert rc == 0
    assert "seqalign stats: pairs=1 cells=36" in err


def test_stats_off_no_line():
    rc, out, err = _run(needleman_wunsch.main, ["prog", "ACGT", "ACAT"])
    assert rc == 0 and "stats" not in err


PAIRS_FA = (">a1\nACGTACGT\n>b1\nACTTACGT\n"
            ">a2\nGGGG\n>b2\nGGCG\n"
            ">a3\nTTTTA\n>b3\nTTATA\n")


def _nw_file_run(tmp_path, monkeypatch, env):
    fa = tmp_path / "pairs.fa"
    fa.write_text(PAIRS_FA)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    return _run(needleman_wunsch.main, ["prog", "--printscores", "--file",
                                        str(fa)])


def test_skip_pairs(tmp_path, monkeypatch):
    rc0, full, _ = _nw_file_run(tmp_path, monkeypatch, {})
    rc1, skipped, _ = _nw_file_run(tmp_path, monkeypatch,
                                   {"SEQALIGN_SKIP_PAIRS": "1"})
    assert rc0 == rc1 == 0
    assert skipped == "\n\n".join(full.split("\n\n")[1:])


def test_skip_all_pairs_no_empty_warning(tmp_path, monkeypatch):
    rc, out, err = _nw_file_run(tmp_path, monkeypatch,
                                {"SEQALIGN_SKIP_PAIRS": "99"})
    assert rc == 0 and out == "" and "empty input" not in err


def test_resume_file_roundtrip(tmp_path, monkeypatch):
    off = tmp_path / "resume.off"
    rc, out1, _ = _nw_file_run(tmp_path, monkeypatch,
                               {"SEQALIGN_RESUME_FILE": str(off)})
    assert rc == 0
    assert off.read_text().strip() == "3"
    rc, out2, _ = _nw_file_run(tmp_path, monkeypatch,
                               {"SEQALIGN_RESUME_FILE": str(off)})
    assert rc == 0 and out2 == ""
    off.write_text("2\n")
    rc, out3, _ = _nw_file_run(tmp_path, monkeypatch,
                               {"SEQALIGN_RESUME_FILE": str(off)})
    assert rc == 0
    assert out3 == "\n\n".join(out1.split("\n\n")[2:])
    assert off.read_text().strip() == "3"


def test_resume_file_overrides_skip_env(tmp_path, monkeypatch):
    off = tmp_path / "resume.off"
    off.write_text("2\n")
    rc, out, _ = _nw_file_run(tmp_path, monkeypatch,
                              {"SEQALIGN_RESUME_FILE": str(off),
                               "SEQALIGN_SKIP_PAIRS": "0"})
    monkeypatch.delenv("SEQALIGN_RESUME_FILE")
    monkeypatch.delenv("SEQALIGN_SKIP_PAIRS")
    rc2, full, _ = _nw_file_run(tmp_path, monkeypatch, {})
    assert out == "\n\n".join(full.split("\n\n")[2:])


def test_sw_resume_alignment_index(tmp_path, monkeypatch):
    fa = tmp_path / "p.fa"
    fa.write_text(PAIRS_FA)
    rc, full, _ = _run(smith_waterman.main, ["prog", "--file", str(fa)])
    monkeypatch.setenv("SEQALIGN_SKIP_PAIRS", "2")
    rc2, tail, _ = _run(smith_waterman.main, ["prog", "--file", str(fa)])
    assert rc == rc2 == 0
    assert "== Alignment 2 " in tail
    assert full.endswith(tail) and tail.count("== Alignment") == 1


def test_sw_resume_with_empty_pairs(tmp_path, monkeypatch):
    fa = tmp_path / "p.fa"
    fa.write_text(">a0\nACGTACGT\n>b0\nCGTA\n"
                  ">a1\n\n>b1\nTTTT\n"
                  ">a2\nTTTTA\n>b2\nTTATA\n")
    rc, full, _ = _run(smith_waterman.main, ["prog", "--file", str(fa)])
    assert "== Alignment 1 " in full and "== Alignment 2" not in full
    off = tmp_path / "r.off"
    monkeypatch.setenv("SEQALIGN_RESUME_FILE", str(off))
    off.write_text("2 1\n")
    rc, tail, _ = _run(smith_waterman.main, ["prog", "--file", str(fa)])
    assert rc == 0
    assert full.endswith(tail) and "== Alignment 1 " in tail
    assert off.read_text().split() == ["3", "2"]


def test_trace_dir_writes_profile(tmp_path, monkeypatch):
    """SEQALIGN_TRACE_DIR writes a torch.profiler Chrome trace that holds
    the run's host operations."""
    monkeypatch.setenv("SEQALIGN_TRACE_DIR", str(tmp_path / "trace"))
    monkeypatch.setenv("SEQALIGN_FORCE", "device")
    rc, out, err = _run(needleman_wunsch.main, ["prog", "ACGT", "ACAT"])
    assert rc == 0 and "ACGT" in out
    path = tmp_path / "trace" / "trace.json"
    trace = json.loads(path.read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
