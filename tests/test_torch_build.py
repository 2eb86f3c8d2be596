"""kernels/build.SIGNATURES matches the C entry points in
kernels/csrc/*.cu: every ``extern "C" int *_launch(`` has an entry with
as many arguments, and every pointer parameter is a ctypes.c_void_p —
a pointer passed as c_int is cut to 32 bits without an error."""
import ctypes
import re

import pytest

from repro_torch.kernels import build

_LAUNCH = re.compile(r'extern\s+"C"\s+int\s+(\w+_launch)\s*\(([^)]*)\)', re.S)


def _entries():
    out = {}
    for src in sorted(build.CSRC.glob("*.cu")):
        for name, params in _LAUNCH.findall(src.read_text()):
            out[name] = (src.name, [p.strip() for p in params.split(",")])
    return out


ENTRIES = _entries()


def test_every_entry_point_has_a_signature():
    assert ENTRIES, "no extern \"C\" *_launch entry point found"
    assert set(ENTRIES) == set(build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_signature_matches_the_source(name):
    src, params = ENTRIES[name]
    types = build.SIGNATURES[name]
    assert len(types) == len(params), (src, params)
    for param, ctype in zip(params, types):
        if "*" in param:
            assert ctype is ctypes.c_void_p, f"{src}: {param} is {ctype}"
        elif param.startswith("float"):
            assert ctype is ctypes.c_float, f"{src}: {param} is {ctype}"
        else:
            assert param.startswith("int"), f"{src}: {param}"
            assert ctype is ctypes.c_int, f"{src}: {param} is {ctype}"
