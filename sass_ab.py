#!/usr/bin/env python3
"""Compare the machine code two checkouts built for their Hopper kernels.

    python3 sass_ab.py <tree_a> <tree_b>

Each tree must have built its kernel library first (``python3 kernel_ab.py
<tree> --build-only`` leaves it in ``src/repro_torch/_build/``; the newest
``libstream_k_*.so`` is read). Disassembles both libraries with ``cuobjdump
-sass``, files each kernel under the source it was compiled from (the file
name that the anonymous namespace carries in every mangled kernel name) and
prints, per source, the kernels whose instructions are the same in both
trees, those that differ, and those only one tree has. A change that should
leave a kernel alone must leave its SASS alone. Needs the CUDA toolkit
($CUDA_HOME, else /usr/local/cuda).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

#: the anonymous namespace of a kernel's mangled name, with its source's stem
ANON = r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_[0-9a-f]{8}"


def tool(name):
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name)


def kernels(binary):
    """{(source stem, kernel): [instructions]}: addresses dropped, and the
    anonymous namespace's per-file hash taken out of the mangled names."""
    text = subprocess.run([tool("cuobjdump"), "-sass", str(binary)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            src = re.search(ANON, m.group(1))
            name = (src.group(1) if src else "", re.sub(ANON, "", m.group(1)))
            out[name] = []
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            out[name].append(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line.split(";")[0]).strip())
    return out


def built_library(tree):
    """The tree's newest built kernel library."""
    libs = sorted(Path(tree, "src", "repro_torch", "_build").glob("libstream_k_*.so"),
                  key=lambda p: p.stat().st_mtime)
    if not libs:
        raise SystemExit(f"{tree} has no built kernel library: run "
                         f"python3 kernel_ab.py {tree} --build-only first")
    return libs[-1]


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    trees = sys.argv[1:3]
    found = []
    for tree in trees:
        lib = built_library(tree)
        print(f"{tree}: {lib}")
        found.append(kernels(lib))
    for stem in sorted({s for f in found for s, _ in f}):
        a, b = ({k: v for (s, k), v in f.items() if s == stem} for f in found)
        same = sorted(k for k in a if a[k] == b.get(k))
        differ = sorted(k for k in a if k in b and a[k] != b[k])
        print(f"{stem}.cu: {len(same)} kernels the same, {len(differ)} differ, "
              f"{len(set(a) - set(b))} only in {trees[0]}, {len(set(b) - set(a))} only in "
              f"{trees[1]}")
        for label, names in (("differ", differ), (f"only in {trees[0]}", set(a) - set(b)),
                             (f"only in {trees[1]}", set(b) - set(a))):
            for k in sorted(names):
                print(f"  {label}: {k}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
