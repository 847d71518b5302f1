#!/usr/bin/env python3
"""Compare the machine code two checkouts compile for their Hopper kernels.

    python3 sass_ab.py <tree_a> <tree_b> [source.cu ...]

Compiles each named source of ``src/repro_torch/csrc`` (default:
``quant_i8_i8.cu``, ``stream_k.cu`` and ``grouped_bf16.cu``) of both trees
to a cubin for sm_90a, all at once, disassembles them with ``cuobjdump
-sass`` and prints, per source, the kernels whose instructions are the same
in both trees, those that differ, and those only one tree has. A change
that should leave a kernel alone must leave its SASS alone. Needs the CUDA
toolkit ($CUDA_HOME, else /usr/local/cuda).
"""

import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-cubin"]
DEFAULT_SOURCES = ["quant_i8_i8.cu", "stream_k.cu", "grouped_bf16.cu"]


def tool(name):
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name)


def kernels(cubin):
    """{kernel: [instructions]}: addresses dropped, and the anonymous
    namespace's per-file hash taken out of the mangled names."""
    text = subprocess.run([tool("cuobjdump"), "-sass", str(cubin)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}", "", m.group(1))
            out[name] = []
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            out[name].append(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line.split(";")[0]).strip())
    return out


def main() -> int:
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    trees = sys.argv[1:3]
    sources = sys.argv[3:] or DEFAULT_SOURCES
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for i, tree in enumerate(trees):
            for src in sources:
                cubin = Path(tmp) / f"{i}_{src}.cubin"
                path = Path(tree) / "src" / "repro_torch" / "csrc" / src
                jobs[i, src] = (cubin, subprocess.Popen(
                    [tool("nvcc"), *FLAGS, "-o", str(cubin), str(path)],
                    stderr=subprocess.PIPE, text=True))
        for (i, src), (_, proc) in jobs.items():
            if proc.wait() != 0:
                print(f"nvcc failed on {trees[i]}: {src}\n{proc.stderr.read()}", file=sys.stderr)
                return 1
        for src in sources:
            a, b = kernels(jobs[0, src][0]), kernels(jobs[1, src][0])
            same = sorted(k for k in a if a[k] == b.get(k))
            differ = sorted(k for k in a if k in b and a[k] != b[k])
            print(f"{src}: {len(same)} kernels the same, {len(differ)} differ, "
                  f"{len(set(a) - set(b))} only in {trees[0]}, {len(set(b) - set(a))} only in "
                  f"{trees[1]}")
            for label, names in (("differ", differ), (f"only in {trees[0]}", set(a) - set(b)),
                                 (f"only in {trees[1]}", set(b) - set(a))):
                for k in sorted(names):
                    print(f"  {label}: {k}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
