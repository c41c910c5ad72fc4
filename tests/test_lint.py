"""Source-hygiene lint: reject function-local imports that shadow
module-level names.

Motivation: a function-local ``import numpy as np``
inside ``cli.main()`` made ``np`` function-local for the WHOLE function
body, so an earlier use at cli.py:693 raised UnboundLocalError and every
``--num-chains --rhat-draws`` run crashed after training but before the
exit checkpoint. This lint makes that regression class impossible for
every module in the package (not a reference-parity feature; internal
quality gate).
"""
from __future__ import annotations

import ast
import pathlib

PKG = pathlib.Path(__file__).resolve().parents[1] / "mcmc_ammsb"


def _module_level_names(tree: ast.Module) -> set[str]:
    names: set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            for a in node.names:
                names.add((a.asname or a.name).split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                names.add(a.asname or a.name)
    return names


def _local_import_shadows(tree: ast.Module, top: set[str]) -> list[str]:
    hits: list[str] = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Import):
                for a in node.names:
                    bound = (a.asname or a.name).split(".")[0]
                    if bound in top:
                        hits.append(f"{fn.name}:{node.lineno} import {bound}")
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    bound = a.asname or a.name
                    if bound in top:
                        hits.append(f"{fn.name}:{node.lineno} from-import {bound}")
    return hits


def test_no_function_local_imports_shadow_module_names():
    offenders: list[str] = []
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        top = _module_level_names(tree)
        for hit in _local_import_shadows(tree, top):
            offenders.append(f"{path.relative_to(PKG.parent)}::{hit}")
    assert not offenders, (
        "function-local imports shadow module-level names (this makes the "
        "name function-local for the WHOLE body, so earlier uses raise "
        "UnboundLocalError):\n"
        + "\n".join(offenders)
    )
