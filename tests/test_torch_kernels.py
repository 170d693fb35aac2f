"""The port's kernel loader (ops/kernels.py) and its shared build routine
(utils/build.py), on the CPU: which C entry each CUDA source defines and
which op module declares it, the libraries' names, and the build's
failure path.  Nothing here compiles CUDA."""

import ast
import hashlib
import re
import shutil
from pathlib import Path

import pytest

from vln_imagine_tpu_torch.ops import kernels
from vln_imagine_tpu_torch.utils.build import build_libraries

OPS = Path(kernels.__file__).parent
SOURCES = [src.name for src in kernels.sources()]


def test_every_kernel_source_is_found():
    assert {"attention_fwd.cu", "attention_bwd.cu",
            "layer_norm.cu"} <= set(SOURCES)


@pytest.mark.parametrize("name", SOURCES)
def test_each_source_defines_its_entry_and_an_op_module_declares_it(name):
    """`<stem>.cu` defines the C entry `vln_<stem>`, which an op module
    declares with as many argument types as the entry has parameters."""
    entry = "vln_" + Path(name).stem
    text = (kernels.CSRC / name).read_text()
    m = re.search(r'extern\s+"C"\s+int\s+' + entry + r"\s*\(([^)]*)\)", text)
    assert m, f"{name} defines no extern \"C\" int {entry}(...)"
    assert entry in kernels.ENTRIES, f"no op module declares {entry}"
    declared = kernels.ENTRIES[entry]
    assert len(declared.argtypes) == len(m.group(1).split(","))
    assert declared.launches


@pytest.mark.parametrize("name", SOURCES)
def test_library_names_follow_the_content_of_csrc(name, tmp_path):
    """`build/kernels/<stem>_<16 hex>.so`, the hex being the sha256 of the
    source, every header and the flags (the names a warm cache holds), and
    another name once a header of a copy of csrc/ changes."""
    lib = kernels.kernel_library(kernels.CSRC / name)
    assert lib.parent == kernels.BUILD_DIR
    assert lib.parent.parts[-2:] == ("build", "kernels")
    assert re.fullmatch(Path(name).stem + r"_[0-9a-f]{16}\.so", lib.name)
    h = hashlib.sha256((kernels.CSRC / name).read_bytes())
    for header in sorted(kernels.CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(kernels.NVCC_FLAGS).encode())
    assert lib.name == f"{Path(name).stem}_{h.hexdigest()[:16]}.so"

    csrc = shutil.copytree(kernels.CSRC, tmp_path / "csrc")
    assert kernels.kernel_library(csrc / name).name == lib.name
    header = sorted(csrc.glob("*.cuh"))[0]
    header.write_text(header.read_text() + "\n// changed\n")
    assert kernels.kernel_library(csrc / name).name != lib.name


def _imports(module: Path) -> set[str]:
    """The modules and names `module` imports."""
    out = set()
    for node in ast.walk(ast.parse(module.read_text())):
        if isinstance(node, ast.ImportFrom):
            out.add(node.module)
            out.update(f"{node.module}.{a.name}" for a in node.names)
        elif isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
    return out


@pytest.mark.parametrize("module, other", [("attention", "layer_norm"),
                                           ("layer_norm", "attention")])
def test_op_modules_import_nothing_of_each_other(module, other):
    imported = _imports(OPS / f"{module}.py")
    assert not any(name.startswith(f"vln_imagine_tpu_torch.ops.{other}")
                   for name in imported), imported
    assert "vln_imagine_tpu_torch.ops.kernels" in imported


def test_the_loader_names_no_source_and_no_entry():
    text = (OPS / "kernels.py").read_text()
    for name in SOURCES:
        assert name not in text and Path(name).stem not in text, name
    for entry in kernels.ENTRIES:
        assert entry not in text, entry


def test_a_failed_build_raises_naming_the_source_and_leaves_no_file(tmp_path):
    """Every failing compiler is named with its source; a library that
    built is kept; no temporary file stays behind."""
    good, bad = tmp_path / "good.c", tmp_path / "bad.c"
    good.write_text("int f(void) { return 1; }\n")
    bad.write_text("int g(void) { return }\n")
    out = tmp_path / "out"
    libs = {good: out / "good_x.so", bad: out / "bad_x.so"}
    with pytest.raises(RuntimeError, match="bad.c") as err:
        build_libraries(["g++", "-shared", "-fPIC"], libs)
    assert "good.c" not in str(err.value)
    assert sorted(p.name for p in out.iterdir()) == ["good_x.so"]
    # an existing library is not rebuilt
    build_libraries(["false"], {good: libs[good]})
    assert libs[good].exists()
