"""Workspace storage: persistent columnar arrays with fragments.

Replaces the reference's TileDB workspace/array layout
(variant_storage_manager.cc:99-620): a workspace directory holds arrays;
each array holds immutable fragments (one per import batch) plus JSON
metadata (schema, row bounds).  `consolidate` merges fragments into one —
the equivalent of consolidate_tiledb_array (tools/src/consolidate_tiledb_array.cc).

Fragment payloads come in two formats:
  * v2 (default for local paths): a directory of raw memory-mappable
    column files (`fragment_v2.py`) — opens at zero RAM cost, serves
    out-of-core queries at `segment_size` granularity like the
    reference's TileDB segment reads (variant_storage_manager.cc:478-513)
  * npz (URI/fsspec backends): one compressed .npz of the columnar SoA,
    loaded whole into host RAM

Workspace paths may carry a URI scheme (hdfs://, s3://, gs://,
memory://, ...): those route through fsspec, the reference's
USE_HDFS/TileDB-cloud-FS analog (reference CMakeLists.txt:45,264-266,
tests/run_spark_hdfs.py).  Plain paths stay on POSIX syscalls.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import time
from typing import Dict, List, Optional

import numpy as np

from .columnar import ColumnarStore, FieldData

WORKSPACE_MARKER = "__genomicsdb_tpu_workspace__"


def _fs_for(path: str):
    """(fsspec filesystem, normalized path) for URI paths, else None."""
    if "://" not in path:
        return None
    import fsspec
    fs, p = fsspec.core.url_to_fs(path)
    return fs, p


def create_workspace(path: str, overwrite: bool = False):
    fsp = _fs_for(path)
    if fsp is not None:
        fs, p = fsp
        if fs.isdir(p) and overwrite:
            fs.rm(p, recursive=True)
        fs.makedirs(p, exist_ok=True)
        with fs.open(p.rstrip("/") + "/" + WORKSPACE_MARKER, "w") as f:
            f.write(json.dumps({"version": 1}))
        return
    if os.path.isdir(path) and overwrite:
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)
    marker = os.path.join(path, WORKSPACE_MARKER)
    with open(marker, "w") as f:
        f.write(json.dumps({"version": 1}))


def is_workspace(path: str) -> bool:
    fsp = _fs_for(path)
    if fsp is not None:
        fs, p = fsp
        return fs.isfile(p.rstrip("/") + "/" + WORKSPACE_MARKER)
    return os.path.isfile(os.path.join(path, WORKSPACE_MARKER))


def array_exists(workspace: str, array_name: str) -> bool:
    """True when the array has at least one written fragment."""
    try:
        return bool(_fragment_paths(workspace, array_name))
    except Exception:
        return False


def _array_dir(workspace: str, array_name: str) -> str:
    if "://" in workspace:
        return workspace.rstrip("/") + "/" + array_name
    return os.path.join(workspace, array_name)


def delete_array(workspace: str, array_name: str):
    d = _array_dir(workspace, array_name)
    fsp = _fs_for(d)
    if fsp is not None:
        fs, p = fsp
        if fs.isdir(p):
            fs.rm(p, recursive=True)
        return
    if os.path.isdir(d):
        shutil.rmtree(d)


def _store_to_npz_dict(store: ColumnarStore) -> Dict[str, np.ndarray]:
    arrs: Dict[str, np.ndarray] = {
        "__row__": store.row, "__col__": store.col, "__end__": store.end,
        "__eff_end__": store.eff_end,
    }
    for name, fd in store.fields.items():
        arrs[f"{name}::valid"] = fd.valid
        arrs[f"{name}::values"] = fd.values
        if fd.offsets is not None:
            arrs[f"{name}::offsets"] = fd.offsets
        if fd.outer_offsets is not None:
            arrs[f"{name}::outer"] = fd.outer_offsets
    return arrs


def write_fragment(workspace: str, array_name: str, store: ColumnarStore,
                   metadata: Optional[dict] = None,
                   fmt: Optional[str] = None) -> str:
    """Write one immutable fragment.  fmt: 'v2' (chunked raw columns,
    memory-mappable — the local-path default) or 'npz' (single
    compressed blob — the URI-backend format)."""
    adir = _array_dir(workspace, array_name)
    fsp = _fs_for(adir)
    frag_name = f"fragment_{time.time_ns()}"
    if fsp is not None:
        if fmt == "v2":
            raise ValueError("v2 fragments require a local path")
        fs, p = fsp
        fs.makedirs(p, exist_ok=True)
        frag_path = p.rstrip("/") + "/" + frag_name + ".npz"
        buf = io.BytesIO()
        np.savez_compressed(buf, **_store_to_npz_dict(store))
        with fs.open(frag_path, "wb") as f:
            f.write(buf.getvalue())
        return _finish_fragment_meta(fs, p, store, metadata, frag_path)
    if fmt is None:
        fmt = "v2"
    os.makedirs(adir, exist_ok=True)
    if fmt == "v2":
        from .fragment_v2 import V2_SUFFIX, write_fragment_v2
        frag_path = os.path.join(adir, frag_name + V2_SUFFIX)
        write_fragment_v2(frag_path, store)
    else:
        frag_path = os.path.join(adir, frag_name + ".npz")
        np.savez_compressed(frag_path, **_store_to_npz_dict(store))
    meta = {
        "attribute_order": store.attribute_order,
        "num_rows": store.num_rows,
        "lb_row": store.lb_row,
        "field_meta": {name: {"kind": fd.kind, "dtype": fd.dtype}
                       for name, fd in store.fields.items()},
    }
    if metadata:
        meta.update(metadata)
    meta_path = os.path.join(adir, "metadata.json")
    existing = {}
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            existing = json.load(f)
    # all fragments of an array share one metadata.json: a new fragment
    # with a different attribute set would make older fragments
    # unreadable at open_array time — fail loudly at write time instead
    if existing.get("attribute_order") is not None and \
            list(existing["attribute_order"]) != meta["attribute_order"]:
        raise ValueError(
            f"fragment attribute set {meta['attribute_order']} does not "
            f"match the array's existing schema "
            f"{existing['attribute_order']}; import with the same vid "
            f"or write to a new array")
    # row bounds grow across fragments (update_row_bounds_in_array)
    if "num_rows" in existing:
        meta["num_rows"] = max(existing["num_rows"], meta["num_rows"])
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=1)
    return frag_path


def _finish_fragment_meta(fs, adir, store, metadata, frag_path) -> str:
    """URI-backend metadata update (mirrors the POSIX tail of
    write_fragment, incl. the schema guard)."""
    meta = {
        "attribute_order": store.attribute_order,
        "num_rows": store.num_rows,
        "lb_row": store.lb_row,
        "field_meta": {name: {"kind": fd.kind, "dtype": fd.dtype}
                       for name, fd in store.fields.items()},
    }
    if metadata:
        meta.update(metadata)
    meta_path = adir.rstrip("/") + "/metadata.json"
    existing = {}
    if fs.isfile(meta_path):
        with fs.open(meta_path) as f:
            existing = json.load(f)
    if existing.get("attribute_order") is not None and \
            list(existing["attribute_order"]) != meta["attribute_order"]:
        raise ValueError(
            f"fragment attribute set {meta['attribute_order']} does not "
            f"match the array's existing schema "
            f"{existing['attribute_order']}")
    if "num_rows" in existing:
        meta["num_rows"] = max(existing["num_rows"], meta["num_rows"])
    with fs.open(meta_path, "w") as f:
        json.dump(meta, f, indent=1)
    return frag_path


def _fragment_paths(workspace: str, array_name: str) -> List[str]:
    adir = _array_dir(workspace, array_name)
    fsp = _fs_for(adir)
    if fsp is not None:
        from .fragment_v2 import V2_SUFFIX
        fs, p = fsp
        # no isdir() pre-check: cache-chained filesystems
        # (simplecache::http://...) answer isdir False while ls works
        try:
            entries = fs.ls(p, detail=False)
        except (FileNotFoundError, OSError):
            return []
        # directory entries may list with a trailing slash (v2
        # fragments are directories; HTTP listings append '/')
        return sorted(f.rstrip("/") for f in entries
                      if f.rstrip("/").endswith((".npz", V2_SUFFIX)))
    if not os.path.isdir(adir):
        return []
    from .fragment_v2 import V2_SUFFIX
    return sorted(os.path.join(adir, f) for f in os.listdir(adir)
                  if f.endswith(".npz") or f.endswith(V2_SUFFIX))


def _load_fragment(path: str, meta: dict, fs=None) -> ColumnarStore:
    from .fragment_v2 import V2_SUFFIX, open_fragment_v2
    if path.endswith(V2_SUFFIX):
        if fs is not None:
            # remote v2 fragment (a DIRECTORY of raw column chunks):
            # download to a local spill dir, then memory-map — the
            # reference's remote-workspace reads also materialize
            # segments locally before use (HDFS segment reads,
            # variant_storage_manager.cc:478-513).  Fragments are
            # immutable, so the spill is reusable.
            import hashlib
            import tempfile
            spill_dir = os.path.join(tempfile.gettempdir(),
                                     "gdb_remote_fragments")
            os.makedirs(spill_dir, exist_ok=True)
            local = os.path.join(
                spill_dir,
                hashlib.sha256(path.encode()).hexdigest()[:24]
                + V2_SUFFIX)
            if not os.path.exists(local):
                tmp = local + ".part"
                base = path.rstrip("/")
                for rf in fs.find(base):
                    rel = rf[len(base):].lstrip("/")
                    dst = os.path.join(tmp, rel)
                    os.makedirs(os.path.dirname(dst), exist_ok=True)
                    fs.get_file(rf, dst)
                os.replace(tmp, local)
            path = local
        st = open_fragment_v2(path, mmap=True)
        # row bounds grow across fragments; metadata.json carries the max
        if meta and meta.get("num_rows"):
            st.num_rows = max(st.num_rows, meta["num_rows"])
        return st
    if fs is not None:
        with fs.open(path, "rb") as f:
            data = np.load(io.BytesIO(f.read()))
    else:
        data = np.load(path)
    store = ColumnarStore(num_rows=meta["num_rows"],
                          lb_row=meta.get("lb_row", 0))
    store.attribute_order = list(meta["attribute_order"])
    store.row = data["__row__"]
    store.col = data["__col__"]
    store.end = data["__end__"]
    store.eff_end = data["__eff_end__"]
    for name in store.attribute_order:
        fm = meta["field_meta"][name]
        fd = FieldData(name=name, kind=fm["kind"], dtype=fm["dtype"],
                       valid=data[f"{name}::valid"],
                       values=data[f"{name}::values"])
        if f"{name}::offsets" in data:
            fd.offsets = data[f"{name}::offsets"]
        if f"{name}::outer" in data:
            fd.outer_offsets = data[f"{name}::outer"]
        store.fields[name] = fd
    return store


def open_array(workspace: str, array_name: str) -> ColumnarStore:
    """Load an array, merging fragments column-major if more than one."""
    adir = _array_dir(workspace, array_name)
    fsp = _fs_for(adir)
    if fsp is not None:
        fs, p = fsp
        with fs.open(p.rstrip("/") + "/metadata.json") as f:
            meta = json.load(f)
        frags = _fragment_paths(workspace, array_name)
        if not frags:
            raise FileNotFoundError(f"no fragments in {adir}")
        stores = [_load_fragment(fp, meta, fs=fs) for fp in frags]
        return stores[0] if len(stores) == 1 else merge_stores(stores)
    meta_path = os.path.join(adir, "metadata.json")
    with open(meta_path) as f:
        meta = json.load(f)
    frags = _fragment_paths(workspace, array_name)
    if not frags:
        raise FileNotFoundError(f"no fragments in {adir}")
    stores = [_load_fragment(p, meta) for p in frags]
    if len(stores) == 1:
        return stores[0]
    return merge_stores(stores)


def create_fragment_writer(workspace: str, array_name: str,
                           attribute_order: List[str],
                           field_meta: Dict[str, dict], num_rows: int,
                           lb_row: int = 0):
    """Streaming fragment writer for imports larger than RAM: append
    (col,row)-sorted cell chunks, then .close().  Registers the array's
    metadata.json like write_fragment (schema guard included)."""
    if "://" in workspace:
        raise ValueError("streaming fragment writes require a local path")
    from .fragment_v2 import V2_SUFFIX, FragmentV2Writer
    adir = _array_dir(workspace, array_name)
    os.makedirs(adir, exist_ok=True)
    meta = {
        "attribute_order": list(attribute_order),
        "num_rows": num_rows,
        "lb_row": lb_row,
        "field_meta": {k: dict(v) for k, v in field_meta.items()},
    }
    meta_path = os.path.join(adir, "metadata.json")
    existing = {}
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            existing = json.load(f)
    if existing.get("attribute_order") is not None and \
            list(existing["attribute_order"]) != meta["attribute_order"]:
        raise ValueError(
            f"fragment attribute set {meta['attribute_order']} does not "
            f"match the array's existing schema "
            f"{existing['attribute_order']}")
    if "num_rows" in existing:
        meta["num_rows"] = max(existing["num_rows"], meta["num_rows"])
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=1)
    frag_dir = os.path.join(adir,
                            f"fragment_{time.time_ns()}{V2_SUFFIX}")
    return FragmentV2Writer(frag_dir, attribute_order, field_meta,
                            num_rows=meta["num_rows"], lb_row=lb_row)


def open_array_ooc(workspace: str, array_name: str,
                   segment_size: int = 10 << 20):
    """Open an array for OUT-OF-CORE querying: returns an
    fragment_v2.OocArray that serves memory-bounded column windows
    (the reference's segment_size-granular TileDB reads,
    variant_storage_manager.cc:478-513).  Requires a local array whose
    fragments are v2; multiple fragments are consolidated out-of-core
    first (immutable-fragment arrays consolidate exactly once)."""
    from .fragment_v2 import V2_SUFFIX, OocArray
    if "://" in workspace:
        raise ValueError("out-of-core reads require a local workspace")
    frags = _fragment_paths(workspace, array_name)
    if not frags:
        raise FileNotFoundError(
            f"no fragments in {_array_dir(workspace, array_name)}")
    if len(frags) > 1 or not frags[0].endswith(V2_SUFFIX):
        if not all(p.endswith(V2_SUFFIX) for p in frags):
            raise ValueError(
                "out-of-core reads need v2 fragments; re-import or "
                "consolidate this array with a current build")
        consolidate_array(workspace, array_name)
        frags = _fragment_paths(workspace, array_name)
    return OocArray(frags[0], segment_size=segment_size)


def merge_stores(stores: List[ColumnarStore]) -> ColumnarStore:
    """k-way column-major merge of fragments (consolidation kernel)."""
    base = stores[0]
    if len(stores) == 1 and base.num_cells:
        # single already-(col,row)-sorted fragment: skip the full
        # re-sort + per-field gather (lexsort is stable, so identity
        # order is a no-op) — just recompute effective ENDs
        r, c = base.row, base.col
        if bool(np.all((c[1:] > c[:-1])
                       | ((c[1:] == c[:-1]) & (r[1:] >= r[:-1])))):
            from .columnar import compute_eff_end
            out = ColumnarStore(num_rows=base.num_rows,
                                lb_row=base.lb_row)
            out.attribute_order = list(base.attribute_order)
            out.row, out.col, out.end = r, c, base.end
            out.eff_end = compute_eff_end(out.row, out.col, out.end)
            out.fields = dict(base.fields)
            return out
    n_total = sum(s.num_cells for s in stores)
    out = ColumnarStore(num_rows=max(s.num_rows for s in stores),
                        lb_row=min(s.lb_row for s in stores))
    out.attribute_order = list(base.attribute_order)
    rows = np.concatenate([s.row for s in stores])
    cols = np.concatenate([s.col for s in stores])
    ends = np.concatenate([s.end for s in stores])
    order = np.lexsort((rows, cols))
    out.row, out.col, out.end = rows[order], cols[order], ends[order]
    # recompute effective ENDs across the merged cell set
    from .columnar import compute_eff_end
    out.eff_end = compute_eff_end(out.row, out.col, out.end)
    for name in out.attribute_order:
        fds = [s.fields[name] for s in stores]
        kind, dtype = fds[0].kind, fds[0].dtype
        valid = np.concatenate([fd.valid for fd in fds])[order]
        if kind == "fixed":
            values = np.concatenate([fd.values for fd in fds])[order]
            out.fields[name] = FieldData(name=name, kind=kind, dtype=dtype,
                                         valid=valid, values=values)
            continue
        # ragged: rebuild offsets in merged order
        lens = np.concatenate([np.diff(fd.offsets) if fd.kind != "ragged2d"
                               else np.diff(fd.outer_offsets)
                               for fd in fds])
        if kind == "ragged2d":
            chunks = []
            inner: List[int] = [0]
            outer = np.zeros(n_total + 1, dtype=np.int64)
            cell_values = []
            for fd, s in zip(fds, stores):
                for i in range(s.num_cells):
                    cell_values.append(fd.cell_value(i)
                                       if fd.valid[i] else None)
            for oi, src in enumerate(order):
                v = cell_values[src]
                if v is not None:
                    for sub in v:
                        chunks.append(np.asarray(sub))
                        inner.append(inner[-1] + len(sub))
                    outer[oi + 1] = outer[oi] + len(v)
                else:
                    outer[oi + 1] = outer[oi]
            values = (np.concatenate(chunks) if chunks
                      else np.zeros(0, dtype=fds[0].values.dtype))
            out.fields[name] = FieldData(
                name=name, kind=kind, dtype=dtype, valid=valid,
                values=values, offsets=np.asarray(inner, dtype=np.int64),
                outer_offsets=outer)
            continue
        base_off = np.cumsum([0] + [len(fd.values) for fd in fds[:-1]])
        value_cat = np.concatenate([fd.values for fd in fds])
        abs_starts = np.concatenate(
            [fd.offsets[:-1] + b for fd, b in zip(fds, base_off)])
        # vectorized gather in merged order (one segment copy per field)
        new_lens = lens[order].astype(np.int64)
        new_offsets = np.zeros(n_total + 1, dtype=np.int64)
        np.cumsum(new_lens, out=new_offsets[1:])
        from .columnar import copy_ragged_segments
        values = np.empty(int(new_offsets[-1]), dtype=value_cat.dtype)
        copy_ragged_segments(value_cat, abs_starts[order], new_lens,
                             new_offsets[:-1], values)
        out.fields[name] = FieldData(name=name, kind=kind, dtype=dtype,
                                     valid=valid, values=values,
                                     offsets=new_offsets)
    return out


def consolidate_array(workspace: str, array_name: str):
    """Merge all fragments into one (consolidate_tiledb_array equivalent).

    All-v2 local arrays consolidate OUT-OF-CORE: fragments are k-way
    merged in bounded column windows (fragment_v2.consolidate_v2_
    streaming), so partitions larger than RAM consolidate fine."""
    frags = _fragment_paths(workspace, array_name)
    if len(frags) <= 1:
        return
    from .fragment_v2 import V2_SUFFIX, consolidate_v2_streaming
    fsp = _fs_for(_array_dir(workspace, array_name))
    if fsp is None and all(p.endswith(V2_SUFFIX) for p in frags):
        adir = _array_dir(workspace, array_name)
        out = os.path.join(adir, f"fragment_{time.time_ns()}{V2_SUFFIX}")
        consolidate_v2_streaming(frags, out)
        for p in frags:
            shutil.rmtree(p)
        return
    store = open_array(workspace, array_name)
    fsp = _fs_for(_array_dir(workspace, array_name))
    for p in frags:
        if fsp is not None:
            fsp[0].rm(p)
        elif os.path.isdir(p):
            shutil.rmtree(p)
        else:
            os.remove(p)
    write_fragment(workspace, array_name, store)
