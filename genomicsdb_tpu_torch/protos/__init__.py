"""The port's protobuf schemas and the loader of their Python bindings.

`bindings(subpackage, names)` compiles `<subpackage>/<name>.proto` with
protoc into `<subpackage>/generated/`, a package of its own, at first
use (and again when a `.proto` is newer than its module), rewrites
protoc's top-level `import <name>_pb2 as ...` lines into
package-relative imports, and imports every module by its qualified
name, `genomicsdb_tpu_torch.protos[.<subpackage>].generated.<name>_pb2`.
Nothing is added to `sys.path`, so the modules that run are the port's
own even where another copy of the same `.proto` files was compiled and
imported under the bare module names.  protobuf's default descriptor
pool accepts a file twice when both copies are byte-identical, and
then makes one message class per descriptor: messages are data, and
two such copies share their classes.

protoc writes into a temporary directory beside the package and each
module is moved into place whole (`os.replace`), so processes that
start at once never import a half-written module.
"""

from __future__ import annotations

import importlib
import os
import re
import shutil
import subprocess
import tempfile
from typing import Dict, Sequence

_HERE = os.path.dirname(os.path.abspath(__file__))
# protoc's import of a dependency compiled beside the module
_TOP_LEVEL_IMPORT = re.compile(r"^import (\w+_pb2) as (\w+)$", re.M)


def _stale(src: str, gen: str) -> bool:
    if not os.path.isfile(gen) or os.path.getmtime(gen) < \
            os.path.getmtime(src):
        return True
    with open(gen) as f:
        return _TOP_LEVEL_IMPORT.search(f.read()) is not None


def bindings(subpackage: str, names: Sequence[str]) -> Dict[str, object]:
    """{name: the imported `<name>_pb2` module} for the `.proto` files
    `names` of `subpackage` ("" for this package, "compat" for the
    reference's wire-compatible schemas)."""
    parts = [p for p in subpackage.split(".") if p]
    proto_dir = os.path.join(_HERE, *parts)
    gen_dir = os.path.join(proto_dir, "generated")
    srcs = [os.path.join(proto_dir, f"{n}.proto") for n in names]
    if any(_stale(s, os.path.join(gen_dir, f"{n}_pb2.py"))
           for s, n in zip(srcs, names)):
        os.makedirs(gen_dir, exist_ok=True)
        init = os.path.join(gen_dir, "__init__.py")
        if not os.path.isfile(init):
            open(init, "a").close()
        tmp = tempfile.mkdtemp(prefix=".protoc-", dir=gen_dir)
        try:
            subprocess.run(["protoc", f"--python_out={tmp}",
                            f"-I{proto_dir}", *srcs],
                           check=True, capture_output=True)
            for n in names:
                path = os.path.join(tmp, f"{n}_pb2.py")
                with open(path) as f:
                    text = _TOP_LEVEL_IMPORT.sub(r"from . import \1 as \2",
                                                 f.read())
                with open(path, "w") as f:
                    f.write(text)
                os.replace(path, os.path.join(gen_dir, f"{n}_pb2.py"))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        importlib.invalidate_caches()
    pkg = ".".join([__name__, *parts, "generated"])
    return {n: importlib.import_module(f"{pkg}.{n}_pb2") for n in names}
