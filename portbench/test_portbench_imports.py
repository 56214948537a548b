"""What the benchmark imports: never JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is not ``repro``), and in
the plain reference nothing of the program (``repro_torch``) nor of the
harness's program side.

    python -m pytest -q portbench/test_portbench_imports.py
"""

import ast
import subprocess
import sys

import pytest

from portbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in spec.BENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)


def _imports(path):
    """(top-level module, module as written) of every import in ``path``;
    a relative import is resolved against the ``portbench`` package."""
    tree = ast.parse(path.read_text())
    pkg = path.relative_to(spec.ROOT).with_suffix("").parts[:-1]
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(a.name.split(".")[0], a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = list(pkg[:len(pkg) - node.level + 1])
                name = ".".join(base + ([node.module] if node.module
                                        else []))
                out.append((name.split(".")[0], name))
                if not node.module:
                    out += [(base[0], ".".join(base + [a.name]))
                            for a in node.names]
            else:
                out.append((node.module.split(".")[0], node.module))
    return out


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(spec.BENCH)) for p in SOURCES])
def test_no_jax_and_no_jax_package(path):
    bad = [full for top, full in _imports(path) if top in FORBIDDEN]
    assert not bad, bad


def test_a_prefix_is_not_the_jax_package():
    # the rule compares whole names: the port's name starts with the JAX
    # package's
    assert "repro_torch".split(".")[0] not in FORBIDDEN


REFERENCE_SIDE = sorted((spec.BENCH / "reference").glob("*.py")) + [
    spec.BENCH / n for n in ("weights.py", "spec.py", "traffic.py",
                             "compare.py", "flops.py")]


@pytest.mark.parametrize("path", REFERENCE_SIDE,
                         ids=[p.name for p in REFERENCE_SIDE])
def test_reference_takes_nothing_of_the_program(path):
    bad = [full for top, full in _imports(path)
           if top == "repro_torch"
           or full in ("portbench.program", "portbench.harness",
                       "portbench.run")]
    assert not bad, bad


def test_a_run_loads_no_jax():
    """A whole CPU run in a fresh process, then its modules."""
    code = (
        "import sys, time, torch\n"
        "sys.path[:0] = ['src', '.']\n"
        "from portbench import harness, spec, run\n"
        "harness.run_cell('granite_moe_1b.async4.s4096_b2', 7, 0.5, False, "
        "device=torch.device('cpu'), t_start=time.perf_counter(), "
        "sizes_fn=spec.reduced_sizes, traffic_over={'seq_len': 128, "
        "'rows': 2}, dtype=torch.float32)\n"
        "print('loaded', run.forbidden_modules())\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "loaded []" in r.stdout, r.stdout
