"""Nothing under benchmark/ loads JAX or the JAX package, and the reference
loads nothing of the program; BENCHMARK.json's names and units keep to
their characters."""
from __future__ import annotations

import ast
import json
import re
import subprocess
import sys

import pytest

from conftest import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "mmearth_tpu", "bench", "scripts"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def sources():
    return sorted(p for p in BENCH_DIR.rglob("*.py") if "cache" not in p.parts)


def imported_tops(path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_source_imports(path):
    tops = imported_tops(path)
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    if "reference" in path.relative_to(BENCH_DIR).parts:
        assert "mmearth_tpu_torch" not in tops and "harness" not in tops


def _loaded(code: str) -> set[str]:
    prog = (f"import sys; sys.path[:0] = [{str(BENCH_DIR)!r}, {str(ROOT)!r}]\n{code}\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_every_module_loads_no_jax():
    code = ["import importlib, importlib.util, pathlib"]
    for p in sources():
        rel = p.relative_to(BENCH_DIR)
        if rel.parts[0] == "tests":
            continue  # read by test_source_imports
        if rel.parts[0] in ("harness", "reference"):
            code.append(f"importlib.import_module({'.'.join(rel.with_suffix('').parts)!r})")
        else:
            code.append(f"s = importlib.util.spec_from_file_location('m{len(code)}', {str(p)!r}); "
                        "m = importlib.util.module_from_spec(s); s.loader.exec_module(m)")
    code.append("from harness import program, feed\nimport mmearth_tpu_torch.train.pretrain")
    tops = _loaded("\n".join(code))
    assert not tops & {"jax", "jaxlib", "flax", "mmearth_tpu"}, tops
    assert "mmearth_tpu_torch" in tops  # compared whole: the port's name is allowed


def test_reference_loads_nothing_of_the_program():
    tops = _loaded("import reference.model, reference.step, reference.flops, "
                   "reference.precision")
    assert "mmearth_tpu_torch" not in tops and "harness" not in tops


def test_forbidden_names_compare_whole():
    from harness.cell import forbidden_modules

    sys.modules.setdefault("mmearth_tpu_torch_probe", sys)
    assert "mmearth_tpu" not in forbidden_modules()


def test_names_and_units():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [w["config"] for w in bench["workloads"]] + [w["traffic"] for w in bench["workloads"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in (bench["configs"], bench["workloads"], metrics):
        assert len({g["name"] for g in group}) == len(group)
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(bench["workloads"])


def test_files_are_found_by_name():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH_DIR / "limits" / f"{w['name']}.json").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] != "setup_s":
            assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file(), m["name"]
