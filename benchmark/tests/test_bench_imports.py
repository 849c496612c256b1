"""What the command imports holds no ``jax``, ``jaxlib``, ``flax`` or
``sixdgs_tpu`` (top-level names compared whole: ``sixdgs_torch`` begins
with ``sixdgs_t`` and is allowed), and the plain reference imports nothing
of the program."""

import ast
import json
import subprocess
import sys

from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "sixdgs_tpu"}


def test_a_run_loads_no_jax(tiny_root):
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(REPO / 'benchmark' / 'tests')!r})\n"
        "from conftest import run_cell\n"
        f"rc, _ = run_cell({str(tiny_root)!r}, 'dinov2_s14.train')\n"
        "print(json.dumps({'rc': rc, 'tops': sorted({m.split('.')[0] for m in sys.modules})}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=600)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["rc"] == 0
    assert "sixdgs_torch" in res["tops"]
    assert not FORBIDDEN & set(res["tops"])


def test_reference_imports_nothing_of_the_program():
    code = ("import sys\n"
            "import benchmark.reference.pose_common, benchmark.reference.dino, "
            "benchmark.reference.superpoint\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=300)
    tops = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert not ({"sixdgs_torch"} | FORBIDDEN) & tops
    for path in (REPO / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in {"sixdgs_torch"} | FORBIDDEN, (path, name)


def test_no_benchmark_file_reads_the_jax_side():
    for path in (REPO / "benchmark").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)
