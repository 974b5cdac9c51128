"""Compare the SASS of two builds of the kernel library, kernel by kernel.

    python3 tools/sass_diff.py OLD.so NEW.so

runs ``cuobjdump -sass`` on both libraries (``navierstokes_tpu_torch/
_build/libns_*.so``), splits the listings by function and compares each
function's instructions by name.  Anonymous namespaces are mangled with a
per-file hash, so that part of every name is masked before the
comparison.  Prints one JSON line: the functions of each, those only in
one, and those whose SASS differs; exits 1 unless both hold the same
functions with the same SASS.  Needs the CUDA toolkit (``cuobjdump`` on
the PATH or under ``$CUDA_HOME/bin``).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_(\d+_\w+?_cu)_[0-9a-f]+")


def _cuobjdump() -> str:
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    return shutil.which("cuobjdump") or str(cuda_home / "bin" / "cuobjdump")


def functions(lib: str) -> dict:
    """``{name: SASS lines}`` of every function in ``lib``."""
    out = subprocess.run([_cuobjdump(), "-sass", lib], check=True,
                         capture_output=True, text=True).stdout
    funcs, name = {}, None
    for line in _ANON.sub(r"_GLOBAL__N__\1", out).splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            funcs[name] = []
        elif name is not None and line.strip():
            funcs[name].append(line.strip())
    return funcs


def main(old: str, new: str) -> int:
    a, b = functions(old), functions(new)
    differ = sorted(k for k in a.keys() & b.keys() if a[k] != b[k])
    report = {"functions": [len(a), len(b)],
              "only_old": sorted(a.keys() - b.keys()),
              "only_new": sorted(b.keys() - a.keys()),
              "differ": differ,
              "same": not differ and a.keys() == b.keys()}
    print(json.dumps(report))
    return 0 if report["same"] else 1


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
