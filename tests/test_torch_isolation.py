"""The port (seqalign_tpu_torch) and chip_smoke.py import no JAX and
nothing of the JAX package: the port keeps its own copies of the jax-free
layers it needs (scoring, packer, host DP)."""

import ast
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "seqalign_tpu_torch")
SHARED = ()  # modules of seqalign_tpu the port may import: none


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_port_sources_exist():
    names = {os.path.relpath(p, ROOT) for p in _sources()}
    for want in ("seqalign_tpu_torch/aligners.py",
                 "seqalign_tpu_torch/ops/dp.py",
                 "seqalign_tpu_torch/ops/pack.py",
                 "seqalign_tpu_torch/ops/traceback.py",
                 "seqalign_tpu_torch/ops/kernels.py",
                 "seqalign_tpu_torch/ops/build.py",
                 "seqalign_tpu_torch/ops/host_dp.py",
                 "seqalign_tpu_torch/ops/oracle.py",
                 "seqalign_tpu_torch/io/packer.py",
                 "seqalign_tpu_torch/scoring/config.py",
                 "seqalign_tpu_torch/scoring/loader.py",
                 "seqalign_tpu_torch/scoring/presets.py",
                 "seqalign_tpu_torch/parallel/engine.py",
                 "seqalign_tpu_torch/parallel/distributed.py",
                 "seqalign_tpu_torch/parallel/wavefront_sp.py",
                 "seqalign_tpu_torch/parallel/dryrun.py",
                 "seqalign_tpu_torch/examples/nw_example.py",
                 "seqalign_tpu_torch/examples/sw_example.py"):
        assert want in names


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import_in_source(path):
    with open(path) as fh:
        text = fh.read()
    assert not re.search(r"^\s*(import jax|from jax)\b", text, re.M)
    tree = ast.parse(text)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [f"{node.module}.{a.name}" for a in node.names]
        else:
            continue
        for m in mods:
            assert m.split(".")[0] not in ("jax", "jaxlib"), (path, m)
            if m == "seqalign_tpu" or m.startswith("seqalign_tpu."):
                assert SHARED and m.startswith(SHARED), (path, m)


def test_port_runs_without_loading_jax():
    code = (
        "import sys\n"
        "import seqalign_tpu_torch as st\n"
        "nw = st.NeedlemanWunsch(device='cpu')\n"
        "a = nw.align_batch(['CAGACGT', 'acgt'], ['CGATA', 'agt'])\n"
        "assert (a[0].result_a, a[0].result_b, a[0].score) == "
        "('C-AGACGT', 'CGATA---', -11), a\n"
        "assert list(nw.score_batch(['CAGACGT'], ['CGATA'])) == [-11]\n"
        "pn = st.NeedlemanWunsch(st.presets.scoring_system_BLOSUM62(), "
        "device='cpu')\n"
        "assert pn.score('HEAGAWGHEE', 'PAWHEAE') == 2\n"
        "sw = st.SmithWaterman(device='cpu')\n"
        "hits = [(h.score, h.result_a, h.pos_a, h.pos_b) for h in "
        "sw.align('ACACACTA', 'AGCACACA')]\n"
        "assert hits[:4] == [(10, 'ACACA', 0, 3), (10, 'CACAC', 1, 2), "
        "(6, 'ACA', 0, 5), (6, 'CAC', 3, 2)], hits\n"
        "assert sw.best_score('ACACACTA', 'AGCACACA') == 10\n"
        "assert st.kernel_launch_counts() == dict.fromkeys("
        "st.kernel_launch_counts(), 0)\n"
        "free = st.ScoringConfig(1, -2, -4, -1, no_start_gap_penalty=True, "
        "no_end_gap_penalty=True)\n"
        "f = st.NeedlemanWunsch(free, device='cpu').align('CAGACGTTT', "
        "'GACG')\n"
        "assert (f.result_b, f.score) == ('--GACG---', 4), f\n"
        "lcs = [(h.result_a, h.pos_a, h.pos_b) for h in st.lcs_hits("
        "'ACGTACGTTTACGTA', sw=st.lcs_aligner(device='cpu'))]\n"
        "assert lcs[:2] == [('ACGTA', 0, 10), ('TACGT', 3, 9)], lcs\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'seqalign_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, SEQALIGN_FORCE="device")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
