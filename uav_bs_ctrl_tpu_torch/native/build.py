"""Build the C++ env core: ``python -m uav_bs_ctrl_tpu_torch.native.build``.

The compiler is ``$CXX``, else ``g++``, else ``c++`` on PATH, with the JAX
package's flags (``-O3 -march=native -shared -fPIC -std=c++17``). The shared
object goes to ``native/_build/libuavbs-<hash>.so``, keyed by the source, the
flags, ``<cxx> --version`` and the CPU that ``-march=native`` resolves to, so
a build is reused until one of them changes. It is written under a temporary
name and moved into place, so processes that build at the same time do not
read a half-written file.
"""

import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "env_core.cpp"
BUILD_DIR = HERE / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
COMPILE_TIMEOUT_S = 120


def find_cxx() -> str:
    """``$CXX``, else ``g++``, else ``c++`` on PATH; raises when none is found."""
    cxx = os.environ.get("CXX")
    if cxx:
        found = shutil.which(cxx)
        if found is None:
            raise RuntimeError(f"$CXX is {cxx!r}, which is not an executable on PATH")
        return found
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found is not None:
            return found
    raise RuntimeError("no C++ compiler: $CXX is unset and neither g++ nor c++ is on PATH")


def _query(cmd) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    return out.stdout if out.returncode == 0 else ""


def target(cxx: str) -> Path:
    """The hashed path of the library ``cxx`` builds from the source."""
    digest = hashlib.sha256()
    digest.update(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    digest.update(_query([cxx, "--version"]).encode())
    # The CPU that -march=native stands for (GCC prints it; empty elsewhere).
    digest.update(_query([cxx, "-march=native", "-Q", "--help=target"]).encode())
    return BUILD_DIR / f"libuavbs-{digest.hexdigest()[:16]}.so"


def build(verbose=False) -> Path:
    """The built library's path, compiling it when it is missing; raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    cxx = find_cxx()
    out = target(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    if verbose:
        print(" ".join(cmd), flush=True)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=COMPILE_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"{cxx} timed out after {COMPILE_TIMEOUT_S} s on {SOURCE.name}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed ({proc.returncode}) on {SOURCE.name}:\n"
                           f"{proc.stderr.strip()}")
    os.replace(tmp, out)
    if verbose:
        print(f"built {out}", flush=True)
    return out


if __name__ == "__main__":
    build(verbose=True)
    sys.exit(0)
