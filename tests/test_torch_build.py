"""The C interface the port declares for its kernel libraries
(``ops/cuda/_build._ENTRY``) against the sources the libraries are built
from, read without a compiler: every ``extern "C"`` function
``ananke_*`` that ``csrc/<name>.cu`` defines has a row under library
``name`` with the same argument and result types, and every row names a
function that its library's source defines. A row left behind when an
entry point moves from one source to another would bind a name the
library does not export; a row with one argument too few would hand the
kernel a stream where it reads an int. Also the sources' own headers:
each ``#include "..."`` names a header of ``csrc/``, and each header there
is included by some source (every library's name hashes all of them)."""
import ctypes
import re
from pathlib import Path

import pytest

from ananke_abm_tpu_torch.ops.cuda import _build

CSRC = Path(_build.CSRC)
# C parameter and result types -> the ctypes the port declares for them
CTYPE = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
         "int": ctypes.c_int, "long": ctypes.c_long,
         "float": ctypes.c_float, "const char*": ctypes.c_char_p}
FUNCTION = re.compile(
    r"^(int|long|const char\*)\s+(ananke_\w+)\(([^)]*)\)\s*\{", re.M)


def _c_block(text):
    """The text of a source's ``extern "C" { ... }`` block."""
    start = text.index('extern "C" {')
    return text[start:text.index('}  // extern "C"', start)]


def _defined(lib):
    """{function: ([parameter ctypes], result ctype)} of the ``ananke_*``
    functions that ``csrc/<lib>.cu`` defines in its C block."""
    out = {}
    for ret, name, params in FUNCTION.findall(
            _c_block((CSRC / f"{lib}.cu").read_text())):
        types = []
        for param in params.split(","):
            param = " ".join(param.split())
            if param in ("", "void"):
                continue
            ctype = re.sub(r"\s*\w+$", "", param).replace(" *", "*")
            types.append(CTYPE[ctype])
        out[name] = (types, CTYPE[ret])
    return out


def _declared(lib):
    """The rows of ``_ENTRY[lib]``, and the error-string function every
    library exports, which ``load_library`` declares for each."""
    rows = dict(_build._ENTRY[lib])
    rows["ananke_cuda_error_string"] = ([ctypes.c_int], ctypes.c_char_p)
    return rows


DEFINED = [(lib, fn) for lib in _build.NAMES for fn in sorted(_defined(lib))]
DECLARED = [(lib, fn) for lib in _build.NAMES
            for fn in sorted(_declared(lib))]


def test_every_library_has_a_source_and_a_row_block():
    assert set(_build._ENTRY) == set(_build.NAMES)
    assert {p.stem for p in CSRC.glob("*.cu")} == set(_build.NAMES)


def test_the_parser_finds_every_c_function_of_a_source():
    """Each source's C block defines exactly the functions the parser
    reads (a definition it missed would escape the checks below)."""
    for lib in _build.NAMES:
        block = _c_block((CSRC / f"{lib}.cu").read_text())
        heads = re.findall(r"^(?!//)\S[^\n(]*\b(ananke_\w+)\(", block, re.M)
        assert sorted(heads) == sorted(_defined(lib)), lib


@pytest.mark.parametrize("lib,fn", DEFINED)
def test_each_c_function_has_its_row_under_its_library(lib, fn):
    rows = _declared(lib)
    assert fn in rows, f"{fn} ({lib}.cu) has no row in _ENTRY[{lib!r}]"
    want_args, want_ret = _defined(lib)[fn]
    args, ret = rows[fn]
    assert len(args) == len(want_args), (
        f"{fn}: _ENTRY has {len(args)} arguments, {lib}.cu takes "
        f"{len(want_args)}")
    assert list(args) == want_args
    assert ret is want_ret


@pytest.mark.parametrize("lib,fn", DECLARED)
def test_each_row_names_a_function_its_library_defines(lib, fn):
    assert fn in _defined(lib), (
        f"_ENTRY[{lib!r}] declares {fn}, which {lib}.cu does not define")


SOURCES = sorted(p.name for p in CSRC.iterdir()
                 if p.suffix in (".cu", ".cuh"))


def _local_includes(name):
    return re.findall(r'^#include "([^"]+)"', (CSRC / name).read_text(),
                      re.M)


@pytest.mark.parametrize("name", SOURCES)
def test_each_local_include_names_a_header_of_csrc(name):
    for header in _local_includes(name):
        assert (CSRC / header).is_file(), f"{name} includes {header}"


def test_every_header_is_included_by_a_source():
    used = {h for name in SOURCES for h in _local_includes(name)}
    assert {p.name for p in CSRC.glob("*.cuh")} <= used
