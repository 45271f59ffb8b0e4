"""Where the port keeps what it builds: the counterpart of the JAX
package's persistent XLA compile cache (``utils/cache.py``).

The port compiles its CUDA kernels and its host libraries at first use,
each into a directory named by the hash of its sources and flags, so a
build is reused by every later process that points at the same place.
The default is ``build/`` under the repository root.
"""

from __future__ import annotations

import os
from typing import Optional

from .. import _build
from ..codec import rans
from . import native_golden

_DEFAULT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "build")


def enable_compile_cache(path: Optional[str] = None) -> None:
    """Build the kernels into ``<path>/torch_kernels`` and the host
    libraries into ``<path>/torch_host`` (``path`` defaults to ``build/``).
    Raises once a library is loaded: the process goes on using that one."""
    loaded = [name for name, mod in (("kernels", _build), ("rANS", rans),
                                     ("golden", native_golden))
              if mod._lib is not None]
    if loaded:
        raise RuntimeError(f"libraries already loaded ({', '.join(loaded)}): "
                           f"set the compile cache before the first build")
    root = os.path.abspath(path or _DEFAULT)
    _build._BUILD_ROOT = os.path.join(root, "torch_kernels")
    rans._BUILD_ROOT = os.path.join(root, "torch_host")
    native_golden._BUILD_ROOT = os.path.join(root, "torch_host")
