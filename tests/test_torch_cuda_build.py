"""The CUDA build and binding of bioreason_tpu_torch, checked without nvcc:
the library's file name follows every source and header it is built from,
and the ctypes argument lists match the C entries of csrc/*.cu."""

import ctypes
import re
import shutil

import pytest

from bioreason_tpu_torch.ops import cuda_build
from bioreason_tpu_torch.ops import flash_attention as tfa
from bioreason_tpu_torch.tools import kernel_variants

ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def c_entries():
    """name -> [parameter declarations] of every extern "C" entry in csrc/*.cu."""
    out = {}
    for path in sorted(cuda_build.CSRC_DIR.glob("*.cu")):
        for name, params in ENTRY.findall(path.read_text()):
            out[name] = [p.strip() for p in params.split(",")]
    return out


def ctype_of(decl: str):
    """The ctypes type a C parameter declaration is passed as."""
    if "*" in decl:
        return ctypes.POINTER(ctypes.c_longlong) if "long long" in decl else ctypes.c_void_p
    if "float" in decl:
        return ctypes.c_float
    if "long long" in decl:
        return ctypes.c_longlong
    if re.search(r"\bint\b", decl):
        return ctypes.c_int
    raise AssertionError(f"unknown parameter kind: {decl}")


@pytest.mark.parametrize("library", tfa.LIBRARIES)
def test_library_name_follows_source_and_headers(library, tmp_path):
    """A changed header (csrc/*.cuh, included by both sources) or a changed
    source gives a new library file, so a stale build is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the sources share a header"
    source = f"{library}.cu"

    def name():
        return cuda_build.library_file(library, source, csrc, tmp_path / "build").name

    first = name()
    assert first == name()
    assert first == cuda_build.library_file(library, source).name     # same content
    headers[0].write_text(headers[0].read_text() + "\n// changed\n")
    second = name()
    assert second != first
    (csrc / source).write_text((csrc / source).read_text() + "\n// changed\n")
    assert name() not in (first, second)


@pytest.mark.parametrize("entry,variant", sorted(kernel_variants.VARIANTS))
def test_kernel_variant_applies_to_the_source(entry, variant):
    """Every text change of the design-variant timer still finds its text in
    the source it changes (it replaces each occurrence), and each entry has
    a shape to time."""
    text = (cuda_build.CSRC_DIR / f"{entry}.cu").read_text()
    for old, _ in kernel_variants.VARIANTS[entry, variant]:
        assert old in text, (entry, variant, old)
    assert kernel_variants.SHAPES[entry]


def test_every_c_entry_has_a_binding():
    assert set(c_entries()) == {f"{e}_bf16" for e in tfa._ARGTYPES}


@pytest.mark.parametrize("entry", sorted(tfa._ARGTYPES))
def test_binding_matches_the_c_signature(entry):
    """Each ctypes argument list has the C entry's parameter count and
    kinds (pointer, int, long long, float, long long array), in order."""
    params = c_entries()[f"{entry}_bf16"]
    want = [ctype_of(p) for p in params]
    got = tfa._ARGTYPES[entry]
    assert len(got) == len(want), (entry, len(got), len(want))
    for i, (g, w, decl) in enumerate(zip(got, want, params)):
        assert g == w, f"{entry} parameter {i} ({decl}): ctypes {g}, C {w}"
