"""Kernel attributes are set once, when the library is loaded, never inside a
launch: ``cudaFuncSetAttribute`` appears in ``vloam_tpu_torch/csrc/*.cu`` only
inside an ``extern "C" int vloam_*_setup()`` function, and ``kernels.lib()``
binds and calls every such function, once.  Checked on the sources and with
the library replaced by a recording stand-in: nothing is built here.
"""

import re
from pathlib import Path

import pytest

from vloam_tpu_torch import kernels

SETUP = re.compile(r'extern "C" int (vloam_\w+_setup)\(\)\s*\{')


def setup_bodies(text: str) -> dict:
    """name -> (start, end) of each setup function's body in ``text``."""
    out = {}
    for m in SETUP.finditer(text):
        depth, i = 1, m.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        out[m.group(1)] = (m.end(), i)
    return out


def sources() -> dict:
    return {path.name: path.read_text() for path in sorted(kernels.SRC_DIR.glob("*.cu"))}


@pytest.mark.parametrize("name", kernels.SOURCES)
def test_attributes_are_set_only_in_setup_functions(name):
    text = sources()[name]
    bodies = setup_bodies(text).values()
    for m in re.finditer(r"cudaFuncSetAttribute", text):
        line = text.count("\n", 0, m.start()) + 1
        assert any(a <= m.start() < b for a, b in bodies), \
            f"{name}:{line}: cudaFuncSetAttribute outside a vloam_*_setup function"


def test_every_setup_is_bound_and_called_once_by_lib(monkeypatch):
    """The setups in the sources are exactly ``kernels.SETUPS``, each has an
    entry in ``_SIGNATURES``, and ``lib()`` calls each once; the launch
    entries are bound and never called."""
    found = {n for text in sources().values() for n in setup_bodies(text)}
    assert found == set(kernels.SETUPS)
    assert all(n in kernels._SIGNATURES for n in found)

    calls = []

    class Entry:
        def __init__(self, name):
            self.name = name

        def __call__(self, *args):
            calls.append(self.name)
            return 0

    class Library:
        def __getattr__(self, name):
            fn = Entry(name)
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(kernels, "build", lambda: Path("stand-in.so"))
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: Library())
    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "_entries", {})
    handle = kernels.lib()
    assert sorted(calls) == sorted(found)
    assert kernels.lib() is handle and sorted(calls) == sorted(found)
    for name, argtypes in kernels._SIGNATURES.items():
        assert kernels.entry(name) is getattr(handle, name)
        assert getattr(handle, name).argtypes == argtypes
