"""PyTorch port: the imports around the captured-program runtime point one
way. programs.py imports nothing from the modules that run programs on it
(onedispatch, pipeline, bitstream, parallel) or from the encoder above
them; those four users import what they need at module level, none
imports onedispatch, pipeline or the encoder inside a function, and none
uses another module's private name; onedispatch and the sharded encode do
not import the encoder at all. Read from the sources with ast: nothing is
imported or run."""

import ast
from pathlib import Path

import pytest

PACKAGE = "dmmt_jpeg_encoder_tpu_torch"
ROOT = Path(__file__).resolve().parents[1] / PACKAGE
# module -> what it may not import anywhere
NOT_IMPORTED = {
    "programs": ("onedispatch", "pipeline", "bitstream", "parallel", "encoder"),
    "onedispatch": ("encoder",),
    "pipeline": (),
    "bitstream.device_pack": (),
    "parallel.sharding": ("encoder",),
}
# what the program users may not import inside a function
NOT_LOCAL = ("onedispatch", "pipeline", "encoder")


def _imports(module: str) -> tuple[ast.Module, list[tuple[str, list[str], bool]]]:
    """The module's tree, and per import of a module of the package (the
    module it names, relative to the package, "" for the package itself;
    the names it takes; whether it sits inside a function)."""
    tree = ast.parse(ROOT.joinpath(*module.split(".")).with_suffix(".py").read_text())
    package = module.split(".")[:-1]
    found = []

    def visit(node: ast.AST, local: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ImportFrom) and child.level:
                base = package[: len(package) - child.level + 1]
                name = ".".join(base + ([child.module] if child.module else []))
                found.append((name, [a.name for a in child.names], local))
            visit(child, local or isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)))

    visit(tree, False)
    return tree, found


def _within(name: str, modules: tuple[str, ...]) -> bool:
    return any(name == m or name.startswith(m + ".") for m in modules)


@pytest.mark.parametrize("module", sorted(NOT_IMPORTED))
def test_program_layer_imports_point_one_way(module):
    tree, found = _imports(module)
    for name, taken, local in found:
        # `from X import y` may bring in the submodule X.y
        for imported in (name, *(f"{name}.{t}".lstrip(".") for t in taken)):
            assert not _within(imported, NOT_IMPORTED[module]), f"{module} imports {imported}"
            if module != "programs":
                assert not (local and _within(imported, NOT_LOCAL)), \
                    f"{module} imports {imported} inside a function"
        private = [t for t in taken if t.startswith("_")]
        assert not private, f"{module} imports private {private} from {name or PACKAGE}"
    # the modules bound by `from <package> import m [as alias]`: none of
    # their private names is read
    aliases = {a.asname or a.name for node in ast.walk(tree)
               if isinstance(node, ast.ImportFrom) and node.level and node.module is None
               for a in node.names}
    private = sorted({f"{n.value.id}.{n.attr}" for n in ast.walk(tree)
                      if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
                      and n.value.id in aliases and n.attr.startswith("_")})
    assert not private, f"{module} reads {private}"
