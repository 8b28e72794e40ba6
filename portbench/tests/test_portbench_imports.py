"""Nothing the benchmark runs imports JAX, Flax or the JAX package
``repro``, and the reference imports nothing of the port either: every
import's top-level name is compared as a whole name, so ``repro_torch``
is not ``repro``."""
import sys
from pathlib import Path

# the harness and the port, after everything else on the path: these
# tests share their processes with the repository's own
for _p in (Path(__file__).resolve().parents[1],
           Path(__file__).resolve().parents[2] / "src"):
    if str(_p) not in sys.path:
        sys.path.append(str(_p))

import ast  # noqa: E402

import pytest  # noqa: E402

from harness import spec  # noqa: E402


FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in spec.BENCH_DIR.rglob("*.py")
               if "tests" not in p.relative_to(spec.BENCH_DIR).parts)


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(spec.BENCH_DIR))
                              for p in FILES])
def test_no_jax_and_a_reference_of_its_own(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    if path.parent.name == "reference":
        assert "repro_torch" not in names
        assert names <= {"__future__", "contextlib", "math", "numpy",
                         "torch", "reference"}, names


def test_whole_names_are_compared(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.core\nfrom repro.codec import x\n")
    names = top_level_imports(f)
    assert "repro_torch" in names and names & FORBIDDEN == {"repro"}
