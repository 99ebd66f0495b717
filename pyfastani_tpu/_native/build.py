"""Build the native host extension in place with the C compiler alone.

    python -m pyfastani_tpu._native.build

Compiles ``fastamod.c`` into ``_native<EXT_SUFFIX>`` beside it in one
compiler call, without setuptools.  The library is written under a
temporary name and renamed into place, so concurrent builds (one per
test worker) cannot leave a torn file.
"""

from __future__ import annotations

import os
import subprocess
import sysconfig

_HERE = os.path.dirname(os.path.abspath(__file__))


def build(cc: str | None = None) -> str:
    """Compile the extension; returns its path, raises if the compiler
    fails."""
    out = os.path.join(_HERE, "_native" + sysconfig.get_config_var("EXT_SUFFIX"))
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [
        cc or os.environ.get("CC") or "cc",
        "-O3", "-pthread", "-shared", "-fPIC",
        "-I", sysconfig.get_paths()["include"],
        os.path.join(_HERE, "fastamod.c"),
        "-o", tmp,
    ]
    subprocess.run(cmd, check=True)
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(build())
