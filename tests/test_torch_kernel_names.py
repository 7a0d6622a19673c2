"""chip_smoke.py's kernel names against the CUDA sources, on the CPU.

chip_smoke.py labels each profiler record by its kernel function's name
(``PROFILE_NAMES``) and prints the ``ptxas -v`` report of each kernel's f32
main-path instantiation by its mangled name (``MAIN_ENTRY``).  A kernel
renamed or re-templated in ``src/repro_torch/csrc/`` without those tables
would only fail on the card, in the profile phase.  These tests read
chip_smoke.py as text (nothing of it runs, no torch is imported) and hold
its tables to the ``__global__`` functions the sources define, and the
sources to their no-atomics contract.
"""
import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "csrc"
SOURCES = sorted(CSRC.glob("*.cu*"))

_GLOBAL = re.compile(
    r"(?:template\s*<(?P<params>[^>]*)>\s*)?__global__\s+void\s+"
    r"(?:__launch_bounds__\s*\([^)]*\)\s*)?(?P<name>\w+)\s*\(")


def _tables(names=("PROFILE_NAMES", "MAIN_ENTRY", "REPLACES")) -> dict[str, dict]:
    """chip_smoke.py's module-level dict literals of those names."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    return {target.id: ast.literal_eval(node.value)
            for node in tree.body if isinstance(node, ast.Assign)
            for target in node.targets
            if isinstance(target, ast.Name) and target.id in names}


def _strip_comments(text: str) -> str:
    return re.sub(r"//[^\n]*|/\*.*?\*/", "", text, flags=re.S)


def _globals() -> dict[str, int]:
    """Every ``__global__`` function under csrc/: name -> template arity."""
    found = {}
    for path in SOURCES:
        for m in _GLOBAL.finditer(_strip_comments(path.read_text())):
            params = m.group("params")
            found[m.group("name")] = len(params.split(",")) if params else 0
    return found


def _demangle(entry: str) -> tuple[str, int]:
    """(name, number of template arguments) of a fragment of an Itanium
    mangled name such as ``19gram_partial_kernelIfLi128ELi4E`` (the name,
    then every template argument without the list's closing ``E``):
    builtin types and ``L…E`` literals only, as the f32 instantiations
    spell them."""
    m = re.fullmatch(r"(\d+)(\w+)", entry)
    assert m, entry
    size = int(m.group(1))
    name, rest = m.group(2)[:size], m.group(2)[size:]
    if not rest:
        return name, 0
    assert rest[0] == "I", entry
    args, i = 0, 1
    while i < len(rest):
        i = rest.index("E", i) + 1 if rest[i] == "L" else i + 1
        args += 1
    return name, args


TABLES = _tables()


def test_chip_smoke_has_the_tables():
    assert {"PROFILE_NAMES", "MAIN_ENTRY", "REPLACES"} <= set(TABLES)
    assert SOURCES


@pytest.mark.parametrize("fn_name", sorted(TABLES["PROFILE_NAMES"]))
def test_profile_name_is_a_global_function_of_the_sources(fn_name):
    assert fn_name in _globals()


@pytest.mark.parametrize("kernel", sorted(TABLES["MAIN_ENTRY"]))
def test_main_entry_names_a_global_function_with_its_template_arity(kernel):
    name, args = _demangle(TABLES["MAIN_ENTRY"][kernel])
    defined = _globals()
    assert name in defined, f"{kernel}: no __global__ {name} under csrc/"
    assert defined[name] == args, (
        f"{kernel}: {TABLES['MAIN_ENTRY'][kernel]} has {args} template arguments, "
        f"{name} takes {defined[name]}")
    assert name in TABLES["PROFILE_NAMES"], f"{name} has no profile label"


@pytest.mark.parametrize("kernel", sorted(TABLES["REPLACES"]))
def test_every_ported_kernel_has_a_main_entry(kernel):
    assert kernel in TABLES["MAIN_ENTRY"]
    assert (CSRC / f"{kernel}.cu").is_file()


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_source_uses_atomics(path):
    assert "atomic" not in _strip_comments(path.read_text())


def test_demangle_reads_template_arguments():
    assert _demangle("19gram_partial_kernelIfLi128ELi4E") == ("gram_partial_kernel", 3)
    assert _demangle("19combine_gram_kernelIfLi64E") == ("combine_gram_kernel", 2)
    assert _demangle("9fold_rect") == ("fold_rect", 0)
