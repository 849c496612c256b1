"""The harness's refusals: no result without a CUDA device, without the
program beside it, or with JAX or the JAX package loaded."""

import subprocess
import sys
import types

from conftest import REPO, copy_tree


def test_no_device_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "dinov2_s14.pose",
                          "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    copy_tree(tmp_path)
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from benchmark import run\n"
            "sys.exit(run.main(['--workload', 'dinov2_s14.pose', '--seed', '1', '--seconds',"
            " '0.01', '--trace', '0'], device='cpu'))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_forbidden_module_no_result(tiny_root, capsys, monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", "dinov2_s14.pose", "--seed", "7", "--seconds", "0.01",
                   "--trace", "0"], root=tiny_root, device="cpu")
    out = capsys.readouterr()
    assert rc != 0 and out.out.strip() == ""
    assert "forbidden modules loaded" in out.err and "jax" in out.err


PLANTED = '''"""DINOv2 reference that loads a module named jax while it judges."""
import sys
import types

from benchmark.reference.dino import GRID, features as _features  # noqa: F401


def features(*a, **k):
    sys.modules.setdefault("jax", types.ModuleType("jax"))
    return _features(*a, **k)
'''


def test_forbidden_module_loaded_while_judging_no_result(tiny_root, capsys):
    from benchmark import run

    (tiny_root / "benchmark" / "reference" / "dino.py").write_text(PLANTED)
    try:
        rc = run.main(["--workload", "dinov2_s14.pose", "--seed", "7", "--seconds", "0.01",
                       "--trace", "0"], root=tiny_root, device="cpu")
        assert "jax" in sys.modules
    finally:
        sys.modules.pop("jax", None)
    out = capsys.readouterr()
    assert rc != 0 and out.out.strip() == ""
    assert "forbidden modules loaded" in out.err and "jax" in out.err
