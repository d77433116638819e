"""Generate guided example notebooks 1-5 from the example scripts.

The reference ships six interactive notebooks (reference:
examples/0_MainDemo..5_Tuning.ipynb); this repo's functional coverage
lives in scripts. For the guided interactive form too, this tool derives
notebooks from the scripts
(single source of truth — regenerate after editing a script):

* module docstring -> markdown intro cell,
* the pre-main import block -> first code cell,
* inside ``main()``: each comment block introducing a code block
  becomes a markdown cell followed by a code cell.

Usage:  python tools/gen_example_notebooks.py
"""

import ast
import json
import os
import re
import textwrap

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")

# (script, notebook, title) — numbering mirrors the reference's.
PLAN = [
    ("1_basics.py", "1_basics.ipynb",
     "Basics: systems, trajectories, tasks, data"),
    ("2_models.py", "2_models.ipynb",
     "System-ID models"),
    ("3_controllers.py", "3_controllers.ipynb",
     "Controllers and tasks"),
    ("6_factories_pipelines.py", "4_factories_pipelines.ipynb",
     "Factories and pipelines"),
    ("5_tuning.py", "5_tuning.ipynb",
     "AutoML tuning"),
]


def md_cell(text):
    return {"cell_type": "markdown", "metadata": {},
            "source": text.splitlines(keepends=True)}


def code_cell(code):
    return {"cell_type": "code", "metadata": {}, "execution_count": None,
            "outputs": [], "source": code.splitlines(keepends=True)}


def split_main_body(src):
    """Return (imports_block, main_body_lines)."""
    tree = ast.parse(src)
    main_def = next(
        n for n in tree.body
        if isinstance(n, ast.FunctionDef) and n.name == "main"
    )
    lines = src.splitlines()
    # Import block: from after the docstring to just before `def main`.
    doc_end = tree.body[0].end_lineno if isinstance(
        tree.body[0], ast.Expr) else 0
    imports = "\n".join(lines[doc_end:main_def.lineno - 1]).strip("\n")
    # Start at the line after `def main():`, not at the first AST
    # statement — comments are not AST nodes and the leading comment
    # block would be silently dropped.
    body_first = main_def.lineno
    body_last = main_def.body[-1].end_lineno
    body = textwrap.dedent("\n".join(lines[body_first:body_last]))
    # Notebook kernels have no __file__; anchor the repo-root path hack
    # on the kernel's working directory instead.
    imports = imports.replace(
        'os.path.join(os.path.dirname(__file__), "..")', 'os.pardir'
    )
    return imports, body


def cells_from_body(body):
    """Split the dedented main() body into markdown/code cells:
    paragraphs (blank-line-separated) whose leading lines are comments
    contribute a markdown cell; the remaining code accumulates into
    code cells between markdown cells."""
    chunks = re.split(r"\n\s*\n", body)
    cells = []
    pend_code = []

    def flush_code():
        nonlocal pend_code
        if pend_code:
            cells.append(code_cell("\n\n".join(pend_code)))
            pend_code = []

    for ch in chunks:
        lines = ch.splitlines()
        lead, i = [], 0
        while i < len(lines) and re.match(r"^\s*#( |$)", lines[i]):
            lead.append(re.sub(r"^\s*# ?", "", lines[i]))
            i += 1
        rest = "\n".join(lines[i:]).strip("\n")
        if lead:
            flush_code()
            cells.append(md_cell("\n".join(lead)))
        if rest:
            pend_code.append(rest)
    flush_code()
    return cells


def main():
    for script, nb_name, title in PLAN:
        src = open(os.path.join(EXAMPLES, script)).read()
        tree = ast.parse(src)
        doc = ast.get_docstring(tree) or title
        imports, body = split_main_body(src)
        cells = [md_cell(f"# {title}\n\n{doc}")]
        if imports:
            cells.append(code_cell(imports))
        cells.extend(cells_from_body(body))
        nb = {
            "nbformat": 4,
            "nbformat_minor": 5,
            "metadata": {
                "kernelspec": {
                    "display_name": "Python 3", "language": "python",
                    "name": "python3",
                },
                "language_info": {"name": "python"},
                "generated_from": script,
            },
            "cells": cells,
        }
        out = os.path.join(EXAMPLES, nb_name)
        with open(out, "w") as f:
            json.dump(nb, f, indent=1)
        n_code = sum(1 for c in cells if c["cell_type"] == "code")
        print(f"wrote {nb_name}: {len(cells)} cells ({n_code} code)")


if __name__ == "__main__":
    main()
