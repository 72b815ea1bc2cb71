"""The port's dataset-preparation scripts (``psalm_tpu_torch/datasets_prep``)
against the repo's ``datasets_prep/``: each copy equals its original by AST
but for its imports (``psalm_tpu_torch`` for ``psalm_tpu``, and the
``sys.path`` line that makes the package importable from the copy's deeper
folder), and ``tests/test_datasets_prep.py``'s seven cases run on the
copies, with the port's ``data/coco_rle.py``, data classes
(``data/datasets.py``) and ``eval_davis.save_indexed_png`` in place of
psalm_tpu's."""

import ast
import importlib
import inspect
import os
import sys

import pytest

import test_datasets_prep as jcases

import psalm_tpu_torch.data.coco_rle as tcoco_rle
import psalm_tpu_torch.data.datasets as tdatasets
import psalm_tpu_torch.eval.eval_davis as teval_davis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "datasets_prep"))
                 if f.endswith(".py"))


class _AsOriginal(ast.NodeTransformer):
    """A copy's two differences undone: psalm_tpu_torch.* in imports reads
    psalm_tpu.*, and its sys.path line climbs one folder less."""

    def visit_ImportFrom(self, node):
        if node.module and node.module.startswith("psalm_tpu_torch"):
            node.module = "psalm_tpu" + node.module[len("psalm_tpu_torch"):]
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        f = node.func
        if (isinstance(f, ast.Attribute) and f.attr == "join"
                and len(node.args) == 3
                and all(isinstance(a, ast.Constant) and a.value == ".."
                        for a in node.args[1:])):
            node.args = node.args[:2]
        return node


def test_seven_scripts_are_copied():
    assert len(SCRIPTS) == 7
    assert all(importlib.util.find_spec(f"psalm_tpu_torch.datasets_prep.{s}")
               for s in SCRIPTS)


@pytest.mark.parametrize("name", SCRIPTS)
def test_copy_equals_original_outside_imports(name):
    original = importlib.import_module(f"datasets_prep.{name}")
    copy = importlib.import_module(f"psalm_tpu_torch.datasets_prep.{name}")
    want = ast.dump(ast.parse(inspect.getsource(original)))
    tree = _AsOriginal().visit(ast.parse(inspect.getsource(copy)))
    assert ast.dump(tree) == want
    for line in inspect.getsource(copy).splitlines():
        if "import" in line and "psalm_tpu" in line:
            assert "psalm_tpu_torch" in line, line


CASES = sorted(n for n, f in vars(jcases).items()
               if n.startswith("test_") and callable(f))


@pytest.mark.parametrize("case", CASES)
def test_original_case_runs_on_the_copies(case, monkeypatch, tmp_path):
    """The case's ``datasets_prep.*``, ``psalm_tpu.data.datasets`` and
    ``psalm_tpu.eval.eval_davis`` imports resolve to the port's modules, and
    its module-level ``coco_rle`` is the port's."""
    for name in SCRIPTS:
        monkeypatch.setitem(sys.modules, f"datasets_prep.{name}",
                            importlib.import_module(
                                f"psalm_tpu_torch.datasets_prep.{name}"))
    monkeypatch.setitem(sys.modules, "psalm_tpu.data.datasets", tdatasets)
    monkeypatch.setitem(sys.modules, "psalm_tpu.eval.eval_davis", teval_davis)
    monkeypatch.setattr(jcases, "coco_rle", tcoco_rle)
    build_davis = importlib.import_module("datasets_prep.build_davis")
    assert build_davis.__name__ == "psalm_tpu_torch.datasets_prep.build_davis"
    assert build_davis.coco_rle is tcoco_rle
    fn = getattr(jcases, case)
    if "tmp_path" in inspect.signature(fn).parameters:
        fn(tmp_path)
    else:
        fn()
