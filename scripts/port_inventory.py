"""List the public top-level names of ``apex_tpu/`` that are missing from
their counterpart file in ``apex_tpu_torch/`` (the same relative path).

A name is public when it does not start with ``_``: a function, a class,
or a module-level assignment target. Files with no counterpart are listed
on their own. Run from the repository's root:

    python scripts/port_inventory.py            # one "file: name" a line
    python scripts/port_inventory.py --count    # the count alone
"""

import argparse
import ast
import os
import sys

REF, PORT = "apex_tpu", "apex_tpu_torch"


def public_names(path: str) -> set:
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        names.add(n.id)
    return {n for n in names if not n.startswith("_")}


def inventory(root: str = "."):
    """(file, name) pairs missing from the port, and files with no
    counterpart, both sorted."""
    missing, no_file = [], []
    ref_root = os.path.join(root, REF)
    for dirpath, _, files in os.walk(ref_root):
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            ref = os.path.join(dirpath, fn)
            rel = os.path.relpath(ref, ref_root)
            port = os.path.join(root, PORT, rel)
            if not os.path.exists(port):
                no_file.append(rel)
                continue
            for name in sorted(public_names(ref) - public_names(port)):
                missing.append((rel, name))
    return sorted(missing), sorted(no_file)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=".")
    p.add_argument("--count", action="store_true")
    args = p.parse_args(argv)
    missing, no_file = inventory(args.root)
    if args.count:
        print(len(missing))
        return 0
    for rel in no_file:
        print(f"{REF}/{rel}: (no counterpart file)")
    for rel, name in missing:
        print(f"{REF}/{rel}: {name}")
    print(f"{len(missing)} names in {len({r for r, _ in missing})} files; "
          f"{len(no_file)} files with no counterpart", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
