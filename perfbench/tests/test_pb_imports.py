"""What the benchmark loads: nothing of JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``), and a reference
that loads nothing of the program."""
import ast
import json
import subprocess
import sys

from conftest import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _fresh(code: str) -> dict:
    env_path = f"{ROOT / 'perfbench'}:{ROOT / 'src'}:{HERE}"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PYTHONPATH": env_path, "PATH": "/usr/bin:/bin",
                                           "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_whole_run_loads_no_jax():
    got = _fresh(
        "import json, sys\n"
        "from conftest import run_small\n"
        "out, run = run_small('qwen2.5-3b.longdoc')\n"
        "out2, run2 = run_small('qwen2.5-3b.train')\n"
        "from harness import cli\n"
        "print(json.dumps({'bad': cli.forbidden_modules(),\n"
        "                  'torch': 'repro_torch' in sys.modules}))")
    assert got == {"bad": [], "torch": True}


def test_reference_loads_nothing_of_the_program():
    got = _fresh(
        "import json, sys\n"
        "import reference, reference.qwen2, reference.mamba1, reference.lowp\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not set(got) & (FORBIDDEN | {"repro_torch", "harness"})


def test_no_source_imports_jax_or_the_jax_package():
    for path in (ROOT / "perfbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, f"{path}: imports {n}"
        if path.parent.name == "reference":
            assert "repro_torch" not in path.read_text(), path
