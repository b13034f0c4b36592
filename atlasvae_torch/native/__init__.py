"""Host helpers in C++, built with g++ at first use and loaded with ctypes.

Each ``<name>.cpp`` here has a plain C interface and is compiled with
``g++ -O2 -shared -fPIC`` into its own library in the port's build
directory (``build/atlasvae_torch`` beside the package, or
``ATLASVAE_TORCH_BUILD_DIR``), never beside the source.  The CUDA kernels
of ``ops/cuda_build.py`` are built by the same ``compile_libraries``, with
nvcc, into the same directory.  Libraries are keyed on a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one is
loaded as it is; a build lands under a temporary name and is renamed into
place, so a concurrent loader never opens half a library.

- ``lzf_decode``: LZF decompression for ``data/hdf5.py``'s chunked reads
  (``data/lzf.py``);
- ``rootio_decode``: the ROOT STL basket decoder and the fused jet
  canonicalisation of the ETL (``etl/rootnative.py``).

Every helper has a plain Python version beside it, which the tests hold it
to.  Nothing here runs when the package is imported.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

SOURCES = ("lzf_decode", "rootio_decode")
GXX_FLAGS = ("-O2", "-shared", "-fPIC")

_HERE = Path(__file__).resolve().parent
_LIBS = {}
_ERRORS = {}
_LOCK = threading.Lock()


def build_dir():
    """Where the port's libraries are built: ``ATLASVAE_TORCH_BUILD_DIR``,
    else ``build/atlasvae_torch`` beside the package."""
    default = _HERE.parents[1] / "build" / "atlasvae_torch"
    return Path(os.environ.get("ATLASVAE_TORCH_BUILD_DIR", default))


def source_path(name):
    return _HERE / f"{name}.cpp"


def keyed_library(name, sources, flags):
    """``build_dir()/lib<name>-<hash>.so``, the hash taken over the bytes of
    ``sources`` and the compiler ``flags``."""
    digest = hashlib.sha1()
    for path in sources:
        digest.update(Path(path).read_bytes())
    digest.update(" ".join(flags).encode())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:12]}.so"


def compile_libraries(targets, compiler, flags):
    """Compile every missing library of ``targets`` ({name: (library,
    source)}), one ``compiler`` process each, all started together.  Returns
    {name: (path, seconds, compiler log)}, the seconds 0 for a library that
    was there; raises RuntimeError naming every compile that failed."""
    build_dir().mkdir(parents=True, exist_ok=True)
    report, jobs = {}, {}
    for name, (lib, src) in targets.items():
        if lib.is_file():
            report[name] = (lib, 0.0, "")
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [compiler, *flags, "-o", str(tmp), str(src)]
        jobs[name] = (lib, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (lib, tmp, start, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: {Path(compiler).name} exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)
        report[name] = (lib, time.perf_counter() - start, log)
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return report


def library_path(name):
    return keyed_library(name, [source_path(name)], GXX_FLAGS)


def build(names=SOURCES):
    """Compile every missing host library among ``names`` with g++ (see
    ``compile_libraries``); FileNotFoundError without g++."""
    return compile_libraries({name: (library_path(name), source_path(name))
                              for name in names}, "g++", GXX_FLAGS)


def load(name):
    """The ctypes handle of ``name``'s library, built on first use, or None
    when it cannot be built here (no g++, a failed compile); ``error(name)``
    then says why.  Thread-safe."""
    if name in _LIBS:
        return _LIBS[name]
    with _LOCK:
        if name not in _LIBS:
            try:
                _LIBS[name] = ctypes.CDLL(str(build((name,))[name][0]))
            except (OSError, RuntimeError) as exc:
                _ERRORS[name] = f"{type(exc).__name__}: {exc}"
                _LIBS[name] = None
    return _LIBS[name]


def error(name):
    """Why ``load(name)`` returned None, or None."""
    return _ERRORS.get(name)
