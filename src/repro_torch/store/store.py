"""LopcStore: a persistent, tile-addressable array store over LOPC
(port of ``repro.store.store`` onto the port's engine and chains).

The compress path turned fields into indexed containers; this is the
layer that keeps them *on disk* and serves random-access reads without
ever re-materializing whole blobs.  A store is a directory:

  store/
    manifest.json        store index (see docs/store.md, normative)
    payload/<name>.lopc    snapshot arrays: one v2 container, verbatim
    payload/<name>.frames  chains: concatenated v3 frame payloads (the
                           frame index lives in the manifest, which is
                           what makes ``append_frame`` a pure file
                           append + manifest swap)

Read path (the point of the subsystem): ``read_roi(name, region)``
parses only the container *head* through a positional
:class:`~repro.core.bitstream.FileSource`, maps the region to tile ids
via the v2 section table, and fetches + decodes only those tiles'
payload byte ranges — the ``executor.DECODE_COUNTS`` probe and the
``FileSource.bytes_read`` counter both prove partial stays partial.
Decoded interiors land in a bounded LRU (:class:`~repro.store.cache.
TileCache`) keyed ``(array, tile_id, content_crc)``, so a hot-region
re-read skips the decode entirely while staying byte-identical to a
cold read (the cached entry *is* the cold decode's output).

Invalidation story: cache keys are content-addressed by the tile crc
from the v2 index, so an overwritten array's stale entries can never
match (they are also dropped eagerly); chain payload files are
append-only with offsets coming from the manifest, and the manifest is
replaced atomically (tmp + rename) — a crashed append leaves ignorable
trailing bytes, never a torn index.

Concurrent readers batch: ``read_roi_many`` deduplicates cache-miss
tiles across requests and decodes them through
``engine.decode_tiles_many`` — tiles of different arrays sharing one
(dtype, tile, order, words) signature ride shared device batches, which
is how the service coalesces store reads from many clients.

The port runs every compress and decode of a store on one torch device,
chosen at open time (``device=``, default ``"cuda"``) like ``solver``
and never written to the manifest: manifests and payloads are the
reference's byte for byte, and a store written on one device reads on
any.  ``read_roi``/``read_tiles`` decode with kernel 3; chain reads
(``read``, ``read_frame``, ``append_frame``'s predictor replay) run the
port's ``temporal.ChainDecoder``.
"""
from __future__ import annotations

import json
import os
import re
import threading
import zlib
from pathlib import Path

import numpy as np

from .. import engine as _engine
from .. import obs as _obs
from .. import temporal as _temporal
from ..core import bitstream
from ..core.nonfinite import encode_nonfinite
from ..core.quantize import abs_bound_from_mode, effective_eps
from ..engine.plan import CompressionPlan, tiles_for_region
from ..temporal.chain import _frame_kind
from .cache import DEFAULT_CACHE_BYTES, TileCache

MANIFEST_NAME = "manifest.json"
PAYLOAD_DIR = "payload"
STORE_FORMAT = "lopc-store"
STORE_VERSION = 1

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,127}$")
_GEN_PAYLOAD_RE = re.compile(r"\.g\d+\.(lopc|frames)$")

# An appended frame may not tighten the chain's pinned bin width; the
# tolerance only absorbs float noise in recomputing the same bound.
_EPS_SLACK = 1.0 - 1e-12


def _atomic_write(path: Path, data: bytes) -> None:
    """Durable replace: fsync the bytes before the rename and the
    directory after it, so a power loss can never persist the rename
    without the contents (the crash-safety story in docs/store.md
    leans on this)."""
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dir_fd = os.open(path.parent, os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


class LopcStore:
    """A directory of named compressed arrays with tile-addressable reads.

    One store pins one :class:`CompressionPlan` (recorded in the
    manifest), so every write — direct or through the service — emits
    the same deterministic bytes.  ``solver`` is an open-time choice,
    not persisted: solvers are byte-identical by contract, so it only
    picks the schedule, never the bytes.  ``device`` is an open-time
    choice too (default ``"cuda"``; ``"cpu"`` runs the kernels' plain
    versions), never persisted.  Thread-safe: manifest mutations hold
    the store lock, reads go through per-call pread slices and the
    locking cache.
    """

    def __init__(self, root, *, create: bool = False,
                 plan: CompressionPlan | None = None, solver: str = "auto",
                 cache_bytes: int = DEFAULT_CACHE_BYTES, device="cuda"):
        self.root = Path(root)
        self.device = _engine.resolve_device(device)
        self._lock = threading.RLock()
        self.cache = TileCache(cache_bytes)
        self._readers: dict[str, tuple] = {}   # name -> (gen, parsed, source)
        self._gen: dict[str, int] = {}
        manifest_path = self.root / MANIFEST_NAME
        if manifest_path.exists():
            m = json.loads(manifest_path.read_text())
            if m.get("format") != STORE_FORMAT or \
                    m.get("version") != STORE_VERSION:
                raise ValueError(
                    f"{manifest_path} is not a {STORE_FORMAT} v{STORE_VERSION} "
                    "manifest"
                )
            mp = m["plan"]
            manifest_plan = CompressionPlan(
                tuple(mp["tile_shape"]) if mp["tile_shape"] else None,
                int(mp["batch_tiles"]),
            )
            if plan is not None and plan != manifest_plan:
                raise ValueError(
                    f"store was created with plan {manifest_plan}, "
                    f"refusing to open with {plan}"
                )
            self.plan = manifest_plan
            self.solver = solver
            self._manifest = m
            self._retire_orphans()
        elif create:
            self.plan = plan or CompressionPlan()
            self.solver = solver
            (self.root / PAYLOAD_DIR).mkdir(parents=True, exist_ok=True)
            self._manifest = {
                "format": STORE_FORMAT,
                "version": STORE_VERSION,
                "plan": {
                    "tile_shape": (list(self.plan.tile_shape)
                                   if self.plan.tile_shape else None),
                    "batch_tiles": self.plan.batch_tiles,
                },
                "arrays": {},
            }
            self._save()
        else:
            raise FileNotFoundError(
                f"no store manifest at {manifest_path} "
                "(pass create=True or use LopcStore.create)"
            )

    # ------------------------------------------------------------ lifecycle

    @classmethod
    def create(cls, root, **kw) -> "LopcStore":
        if (Path(root) / MANIFEST_NAME).exists():
            raise FileExistsError(f"store already exists at {root}")
        return cls(root, create=True, **kw)

    @classmethod
    def open(cls, root, **kw) -> "LopcStore":
        return cls(root, create=False, **kw)

    def close(self) -> None:
        with self._lock:
            for _, _, source in self._readers.values():
                source.close()
            self._readers.clear()

    def __enter__(self) -> "LopcStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- manifest

    def _save(self) -> None:
        _atomic_write(self.root / MANIFEST_NAME,
                      (json.dumps(self._manifest, indent=1) + "\n").encode())

    def _entry(self, name: str, kind: str | None = None) -> dict:
        try:
            e = self._manifest["arrays"][name]
        except KeyError:
            raise KeyError(f"store has no array {name!r}") from None
        if kind is not None and e["kind"] != kind:
            raise ValueError(
                f"{name!r} is a {e['kind']} (wanted {kind}); read chains "
                "with read_frame/read, snapshots with read_roi/read"
            )
        return e

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._manifest["arrays"])

    def info(self, name: str) -> dict:
        with self._lock:
            return json.loads(json.dumps(self._entry(name)))

    def _check_name(self, name: str) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(
                f"bad array name {name!r} (want [A-Za-z0-9][A-Za-z0-9._-]*, "
                "<=128 chars)"
            )

    def _invalidate(self, name: str) -> None:
        """Drop cached state of one array (overwrite/append/delete).

        The stale FileSource is only unreferenced, never closed here: a
        concurrent reader may still be mid-pread on it, and closing the
        fd under it would fail the read (or, with fd reuse, silently
        read another file).  The source's ``__del__`` closes the fd once
        the last in-flight reader drops it."""
        self.cache.invalidate(name)
        self._gen[name] = self._gen.get(name, 0) + 1
        self._readers.pop(name, None)

    def delete(self, name: str) -> None:
        with self._lock:
            e = self._entry(name)
            self._invalidate(name)
            del self._manifest["arrays"][name]
            self._save()
            try:
                (self.root / e["payload"]).unlink()
            except FileNotFoundError:  # pragma: no cover - already gone
                pass

    # --------------------------------------------------------------- write

    def put(self, name: str, blob: bytes) -> None:
        """Persist an already-compressed v2 container under ``name``."""
        with self._lock:
            retired = self._put(name, blob)
            self._save()
            self._retire(retired)

    def _payload_rel(self, name: str, suffix: str) -> str:
        """Payload path for (the next write of) ``name``.  An overwrite
        gets a generation-suffixed file so the manifest swap is the
        single commit point: a crash after the payload lands but before
        the manifest rename leaves an orphan file, never a manifest
        whose offsets/crcs describe different bytes."""
        gen = self._gen.get(name, 0)
        stem = name if name not in self._manifest["arrays"] and gen == 0 \
            else f"{name}.g{gen + 1}"
        return f"{PAYLOAD_DIR}/{stem}.{suffix}"

    def _retire_orphans(self) -> None:
        """Open-time sweep for crash leftovers in ``payload/``.

        A crash between an overwrite's payload write and its manifest
        swap (or between the swap and the best-effort ``_retire``)
        leaves a generation-suffixed payload, and a crash inside
        ``_atomic_write`` leaves a ``.tmp``; the manifest is the single
        commit point, so any such file it does not reference is garbage
        by construction.  Plain (unsuffixed) payloads self-heal — the
        next first write of that name lands on the same path — so only
        the two crash shapes above are swept, and only at open, where
        no concurrent reader can hold the file."""
        pdir = self.root / PAYLOAD_DIR
        if not pdir.is_dir():  # pragma: no cover - manifest without payload/
            return
        live = {e["payload"] for e in self._manifest["arrays"].values()}
        for p in sorted(pdir.iterdir()):
            if f"{PAYLOAD_DIR}/{p.name}" in live:
                continue
            if p.name.endswith(".tmp") or _GEN_PAYLOAD_RE.search(p.name):
                try:
                    p.unlink()
                except OSError:  # pragma: no cover - already gone
                    pass

    def _retire(self, paths) -> None:
        """Unlink replaced payload files (after the manifest swap that
        stopped referencing them; best-effort — a leftover is ignorable
        garbage, exactly like a crash orphan)."""
        for rel in paths:
            try:
                (self.root / rel).unlink()
            except FileNotFoundError:  # pragma: no cover - already gone
                pass

    def _put(self, name: str, blob: bytes) -> list[str]:
        """Write one snapshot payload + manifest entry (no save) ->
        payload paths to retire after the next ``_save()``."""
        self._check_name(name)
        c = bitstream.read_container_v2(blob)  # full validation before disk
        rel = self._payload_rel(name, "lopc")
        _atomic_write(self.root / rel, blob)
        retired = []
        if name in self._manifest["arrays"]:
            old = self._manifest["arrays"][name]["payload"]
            if old != rel:
                retired.append(old)
            self._invalidate(name)
        self._manifest["arrays"][name] = {
            "kind": "snapshot",
            "payload": rel,
            "container_version": bitstream.VERSION_TILED,
            "dtype": str(np.dtype(c.header.dtype)),
            "shape": list(c.header.shape),
            "eb": c.header.eb,
            "eb_mode": c.header.eb_mode,
            "eps_abs": c.header.eps_abs,
            "flags": c.header.flags,
            "tile_shape": list(c.tile_shape),
            "grid": list(c.grid),
            "n_tiles": c.n_tiles,
            "nbytes": len(blob),
            "crc32": zlib.crc32(blob) & 0xFFFFFFFF,
            "data_off": c.data_off,
        }
        return retired

    def write(self, name: str, x, eb, mode: str = "noa",
              preserve_order: bool = True, adaptive_eb: str = "off") -> int:
        """Compress one field and persist it -> stored byte count."""
        return self.write_many([name], [x], eb, mode, preserve_order,
                               adaptive_eb=adaptive_eb)[0]

    def write_many(self, names, fields, eb, mode: str = "noa",
                   preserve_order: bool = True, group_cb=None,
                   adaptive_eb: str = "off") -> list[int]:
        """Compress a batch through one ``engine.compress_many`` call
        (shared device batches — the service's write coalescing) and
        persist every container under its name, with one manifest swap."""
        names = list(names)
        for n in names:
            self._check_name(n)
        blobs = _engine.compress_many(fields, eb, mode, preserve_order,
                                      self.solver, self.plan,
                                      group_cb=group_cb,
                                      adaptive_eb=adaptive_eb,
                                      device=self.device)
        with self._lock:
            retired = []
            for n, b in zip(names, blobs):
                retired += self._put(n, b)
            self._save()
            self._retire(retired)
        return [len(b) for b in blobs]

    def write_chain(self, name: str, frames, eb, mode: str = "noa",
                    preserve_order: bool = True,
                    keyframe_interval=_temporal.DEFAULT_KEYFRAME_INTERVAL,
                    adaptive_eb: str = "off") -> int:
        """Compress a frame sequence as a chain and persist it.

        The chain's bin width (``eps_abs``) is pinned here, from these
        frames; ``append_frame`` extends the chain later under the same
        width.  For ``adaptive_eb="tda"`` the chain-wide eb ladder is
        pinned too (recorded in the manifest, so appended frames keep
        the committed per-tile bounds).  Returns the stored payload byte
        count.
        """
        self._check_name(name)
        frames = list(frames)  # may be a generator; indexed again below
        blob = _temporal.compress_chain(
            frames, eb, mode, preserve_order, self.solver, self.plan,
            keyframe_interval, adaptive_eb=adaptive_eb, device=self.device,
        )
        c = bitstream.read_container_v3(blob)
        # the payload file holds exactly the frame run (appends extend it
        # in place); chain-level extras — the eb ladder — live in the
        # manifest instead
        last_entry = c.entries[-1]
        payload = blob[c.data_off : c.data_off + last_entry.off
                       + last_entry.length]
        ladder = None
        if c.header.flags & bitstream.FLAG_ADAPTIVE_EB:
            ladder = [int(k) for k in c.eb_ladder()]
        last = np.asarray(frames[-1])
        if not np.isfinite(last).all():
            last, _ = encode_nonfinite(last)
        eps_eff = effective_eps(c.header.eps_abs)
        eps_tight = eps_eff * (
            2.0**-bitstream.EB_LADDER_K_MAX if ladder is not None else 1.0)
        last_max_bin = float(np.max(np.abs(last), initial=0.0)) / eps_tight + 4
        self.put_chain_raw(name, {
            "container_version": bitstream.VERSION_CHAIN,
            "dtype": str(np.dtype(c.header.dtype)),
            "shape": list(c.header.shape),
            "eb": c.header.eb,
            "eb_mode": c.header.eb_mode,
            "eps_abs": c.header.eps_abs,
            "flags": c.header.flags,
            "tile_shape": list(c.tile_shape),
            "grid": list(c.grid),
            "keyframe_interval": c.keyframe_interval,
            "last_max_bin": last_max_bin,
            "eb_ladder": ladder,
            "frames": [
                {"kind": e.kind, "flags": e.flags, "off": e.off,
                 "len": e.length, "crc": e.crc}
                for e in c.entries
            ],
        }, payload)
        return len(payload)

    _CHAIN_ENTRY_FIELDS = (
        "container_version", "dtype", "shape", "eb", "eb_mode", "eps_abs",
        "flags", "tile_shape", "grid", "keyframe_interval", "last_max_bin",
        "eb_ladder", "frames",
    )

    def put_chain_raw(self, name: str, entry: dict, payload: bytes) -> None:
        """Persist an already-encoded chain byte-verbatim.

        ``entry`` carries the chain manifest fields ``write_chain``
        records (sans ``payload`` path, which this store picks);
        ``payload`` is the concatenated v3 frame-payload bytes.  Every
        frame's ``(off, len, crc)`` is verified against the bytes and
        the index is required to tile the payload exactly before
        anything lands on disk — this is the cluster replication
        primitive, and a replica must be bit-exact or rejected.
        """
        self._check_name(name)
        frames = entry["frames"]
        if not frames:
            raise ValueError("chain entry has no frames")
        pos = 0
        for i, f in enumerate(frames):
            seg = payload[f["off"]:f["off"] + f["len"]]
            if f["off"] != pos or len(seg) != f["len"] or \
                    (zlib.crc32(seg) & 0xFFFFFFFF) != f["crc"]:
                raise ValueError(
                    f"chain frame {i} bytes do not match its index entry"
                )
            pos += f["len"]
        if pos != len(payload):
            raise ValueError("chain payload has bytes past the frame index")
        new = {"kind": "chain", "payload": None}
        for k in self._CHAIN_ENTRY_FIELDS:
            # "eb_ladder" may be absent in entries from older manifests
            # (uniform chains) — normalize to an explicit None
            v = entry.get(k) if k == "eb_ladder" else entry[k]
            new[k] = json.loads(json.dumps(v))  # detached deep copy
        with self._lock:
            # payload (generation-suffixed on overwrite) lands first,
            # manifest swap commits, old payload retires last — a reader
            # or a crash can never see a manifest whose frame index
            # describes different bytes
            rel = self._payload_rel(name, "frames")
            _atomic_write(self.root / rel, payload)
            retired = []
            if name in self._manifest["arrays"]:
                old = self._manifest["arrays"][name]["payload"]
                if old != rel:
                    retired.append(old)
                self._invalidate(name)
            new["payload"] = rel
            self._manifest["arrays"][name] = new
            self._save()
            self._retire(retired)

    def append_frame(self, name: str, frame) -> int:
        """Append one frame to a stored chain -> its frame index.

        The frame is encoded exactly as ``compress_chain`` would have
        encoded it at this position (keyframe at the committed stride,
        bin residual otherwise, same stored widths — byte-identical,
        tested): a residual append replays only the bins of the current
        keyframe run from disk to rebuild the predictor state, then the
        payload file grows by one frame and the manifest swaps.
        """
        with self._lock:
            e = self._entry(name, "chain")
            t = len(e["frames"])
            x = np.asarray(frame)
            if tuple(x.shape) != tuple(e["shape"]) or \
                    str(x.dtype) != e["dtype"]:
                raise ValueError(
                    f"appended frame is {x.shape}/{x.dtype}, chain "
                    f"{name!r} holds {tuple(e['shape'])}/{e['dtype']}"
                )
            filled = x
            if not np.isfinite(filled).all():
                filled, _ = encode_nonfinite(filled)
            bound = abs_bound_from_mode(filled, e["eb"], e["eb_mode"])
            ladder = e.get("eb_ladder")
            # adaptive chains store the *loosest* rung in eps_abs; the
            # frame's own budget is honored at the tightest rung (the
            # user-equivalent bound), so compare against that
            pinned = e["eps_abs"] * (
                2.0**-bitstream.EB_LADDER_K_MAX if ladder is not None
                else 1.0)
            if bound < pinned * _EPS_SLACK:
                raise ValueError(
                    f"frame {t}'s {e['eb_mode']} bound {bound:.3e} is "
                    f"tighter than the chain's pinned bin width "
                    f"{pinned:.3e}; its point-wise error budget "
                    "cannot be honored — start a new chain"
                )
            kind = _frame_kind(t, e["keyframe_interval"])
            prev_bins = None
            if kind == bitstream.FRAME_RESIDUAL:
                view = self._chain_view(name)
                dec = _temporal.ChainDecoder(view, self.plan, self.device)
                for k in range(view.keyframe_before(t - 1), t):
                    dec.step(k)
                prev_bins = dec.resident_bins()
            sections, nonfinite, max_bin, _ = _temporal.encode_appended_frame(
                x, eps_abs=e["eps_abs"], kind=kind, prev_bins=prev_bins,
                prev_max_bin=e["last_max_bin"],
                preserve_order=bool(e["flags"]
                                    & bitstream.FLAG_ORDER_PRESERVING),
                solver=self.solver, plan=self.plan,
                ladder=(np.asarray(ladder, np.uint8)
                        if ladder is not None else None),
                device=self.device,
            )
            payload = bitstream.serialize_frame_payload(sections,
                                                        nonfinite or b"")
            prev = e["frames"][-1]
            off = prev["off"] + prev["len"]
            with open(self.root / e["payload"], "r+b") as f:
                f.seek(off)
                f.write(payload)
                f.truncate()  # drop any crash leftovers past the new frame
                f.flush()
                os.fsync(f.fileno())  # frame bytes durable BEFORE the
                # manifest that references them can be renamed in
            e["frames"].append({
                "kind": kind,
                "flags": (bitstream.FLAG_HAS_NONFINITE if nonfinite else 0),
                "off": off, "len": len(payload),
                "crc": zlib.crc32(payload) & 0xFFFFFFFF,
            })
            e["last_max_bin"] = max_bin
            self._invalidate(name)
            self._save()
            return t

    # ---------------------------------------------------------------- read

    def _snapshot_reader(self, name: str):
        """-> (parsed ContainerV2 over a FileSource, TileLayout)."""
        with self._lock:
            e = self._entry(name, "snapshot")
            gen = self._gen.get(name, 0)
            cached = self._readers.get(name)
            if cached is not None and cached[0] == gen:
                return cached[1]
            source = bitstream.FileSource(self.root / e["payload"])
            try:
                c = bitstream.open_container_v2(source)
                parsed = (c, _engine.container_layout(c))
            except Exception:
                source.close()
                raise
            self._readers[name] = (gen, parsed, source)
            return parsed

    def _chain_view(self, name: str) -> bitstream.ContainerV3:
        """Manifest-built ContainerV3 view over the chain payload file
        (frame index from json, ``data_off=0``)."""
        with self._lock:
            e = self._entry(name, "chain")
            gen = self._gen.get(name, 0)
            cached = self._readers.get(name)
            if cached is not None and cached[0] == gen:
                return cached[1]
            header = bitstream.Header(
                dtype=np.dtype(e["dtype"]), shape=tuple(e["shape"]),
                eb_mode=e["eb_mode"], eb=e["eb"], eps_abs=e["eps_abs"],
                flags=e["flags"],
            )
            entries = [
                bitstream.FrameEntry(f["kind"], f["flags"], f["off"],
                                     f["len"], f["crc"])
                for f in e["frames"]
            ]
            extra = {}
            if e.get("eb_ladder") is not None:
                extra[bitstream.TAG_EB_LADDER] = bitstream.serialize_eb_ladder(
                    np.asarray(e["eb_ladder"], np.uint8))
            source = bitstream.FileSource(self.root / e["payload"])
            c = bitstream.ContainerV3(
                header, tuple(e["tile_shape"]), tuple(e["grid"]),
                e["keyframe_interval"], entries, extra, 0, source,
            )
            self._readers[name] = (gen, c, source)
            return c

    def n_frames(self, name: str) -> int:
        with self._lock:
            return len(self._entry(name, "chain")["frames"])

    def read_roi(self, name: str, region: tuple) -> np.ndarray:
        """Decode only ``region`` of a stored snapshot array.

        Equals ``decompress(blob)[region]`` byte-for-byte whether every
        tile came cold from disk, warm from the cache, or mixed.
        """
        return self.read_roi_many([(name, tuple(region))])[0]

    def read(self, name: str) -> np.ndarray:
        """Full read: a snapshot array, or a chain as (T, *shape)."""
        with self._lock:
            kind = self._entry(name)["kind"]
        if kind == "chain":
            view = self._chain_view(name)
            dec = _temporal.ChainDecoder(view, self.plan, self.device)
            return np.stack([dec.values(t) for t in range(view.n_frames)])
        # full scans bypass the tile cache on purpose: inserting every
        # tile of an array would evict the hot-region working set for
        # entries a sequential read never revisits
        c, layout = self._snapshot_reader(name)
        region = tuple(slice(0, n) for n in layout.field_shape)
        tile_ids = tiles_for_region(layout, region)
        values = _engine.decode_tiles_for_region(c, tile_ids, self.plan,
                                                 device=self.device)
        return _engine.region_from_tiles(c, layout, region,
                                         dict(zip(tile_ids, values)))

    def read_frame(self, name: str, t: int) -> np.ndarray:
        """Random-access decode of frame ``t`` of a stored chain.

        Replays at most one keyframe plus the bounded residual run,
        fetching only those frames' payload bytes from disk.
        """
        view = self._chain_view(name)
        dec = _temporal.ChainDecoder(view, self.plan, self.device)
        for k in range(view.keyframe_before(t), t):
            dec.step(k)
        return dec.values(t)

    def read_roi_many(self, items, stats_cb=None, group_cb=None
                      ) -> list[np.ndarray]:
        """Batched region reads — the service's store read path.

        ``items`` is a list of ``(name, region)`` pairs.  Cache-miss
        tiles are deduplicated across requests (two readers of one hot
        tile cost one decode) and decoded through
        ``engine.decode_tiles_many``, so misses of different arrays
        share device batches.  ``stats_cb``, when given, receives one
        summary dict (requests, tiles requested/decoded, cache
        hits/misses/evictions) — the service's cache metrics feed.
        """
        items = [(name, tuple(region)) for name, region in items]
        ev0 = self.cache.evictions
        hits = misses = requested = 0
        prep = []                    # per item: (c, layout, region, tiles{})
        pending: dict[str, dict] = {}  # name -> {tile_id: key} to decode
        parsed: dict[str, tuple] = {}  # name -> (c, layout)
        for name, region in items:
            if name not in parsed:
                parsed[name] = self._snapshot_reader(name)
            c, layout = parsed[name]
            tiles: dict[int, np.ndarray | None] = {}
            for tid in tiles_for_region(layout, region):
                requested += 1
                want = pending.get(name, {})
                if tid in want:
                    tiles[tid] = None  # another request already decodes it
                    continue
                key = (name, tid, c.entries[tid].crc)
                v = self.cache.get(key)
                if v is None:
                    misses += 1
                    pending.setdefault(name, {})[tid] = key
                    tiles[tid] = None
                else:
                    hits += 1
                    tiles[tid] = v
            prep.append((c, layout, region, tiles))

        decoded = 0
        with _obs.span("store.read", op="roi", n_requests=len(items),
                       tiles_requested=requested, cache_hits=hits,
                       cache_misses=misses) as rd_sp:
            if pending:
                runs = [(parsed[name][0], sorted(want))
                        for name, want in pending.items()]
                values = _engine.decode_tiles_many(runs, self.plan, group_cb,
                                                   device=self.device)
                fresh: dict[str, dict[int, np.ndarray]] = {}
                for (name, want), vals in zip(pending.items(), values):
                    by_tile = dict(zip(sorted(want), vals))
                    fresh[name] = by_tile
                    decoded += len(by_tile)
                    for tid, v in by_tile.items():
                        self.cache.put(want[tid], v)
                for i, (name, _) in enumerate(items):
                    c, layout, region, tiles = prep[i]
                    for tid, v in tiles.items():
                        if v is None:
                            tiles[tid] = fresh[name][tid]
            rd_sp.set_tag("tiles_decoded", decoded)

        outs = [
            _engine.region_from_tiles(c, layout, region, tiles)
            for c, layout, region, tiles in prep
        ]
        if stats_cb is not None:
            stats_cb({
                "n_requests": len(items),
                "tiles_requested": requested,
                "tiles_decoded": decoded,
                "cache_hits": hits,
                "cache_misses": misses,
                "cache_evictions": self.cache.evictions - ev0,
            })
        return outs

    def read_tiles(self, name: str, tile_ids) -> dict[int, np.ndarray]:
        """Decode specific tiles of a stored snapshot -> {tile_id: interior}."""
        return self.read_tiles_many([(name, tuple(tile_ids))])[0]

    def read_tiles_many(self, items, stats_cb=None, group_cb=None
                        ) -> list[dict[int, np.ndarray]]:
        """Batched tile-granular reads — the cluster router's unit of
        scatter/gather.

        ``items`` is a list of ``(name, tile_ids)`` pairs; each result
        maps ``tile_id -> decoded interior``.  Tiles come from the same
        cache and the same ``engine.decode_tiles_many`` primitive as
        region reads, so a router reassembling a region from per-shard
        tile responses reproduces a single-process ``read_roi``
        byte-for-byte.  ``stats_cb`` matches ``read_roi_many``'s.
        """
        items = [(name, tuple(tids)) for name, tids in items]
        ev0 = self.cache.evictions
        hits = misses = requested = 0
        prep: list[dict[int, np.ndarray | None]] = []
        pending: dict[str, dict] = {}  # name -> {tile_id: key} to decode
        parsed: dict[str, tuple] = {}  # name -> (c, layout)
        for name, tids in items:
            if name not in parsed:
                parsed[name] = self._snapshot_reader(name)
            c, _ = parsed[name]
            tiles: dict[int, np.ndarray | None] = {}
            for tid in tids:
                requested += 1
                if tid in pending.get(name, {}):
                    tiles[tid] = None  # another request already decodes it
                    continue
                key = (name, tid, c.entries[tid].crc)
                v = self.cache.get(key)
                if v is None:
                    misses += 1
                    pending.setdefault(name, {})[tid] = key
                    tiles[tid] = None
                else:
                    hits += 1
                    tiles[tid] = v
            prep.append(tiles)

        decoded = 0
        with _obs.span("store.read", op="tiles", n_requests=len(items),
                       tiles_requested=requested, cache_hits=hits,
                       cache_misses=misses) as rd_sp:
            if pending:
                runs = [(parsed[name][0], sorted(want))
                        for name, want in pending.items()]
                values = _engine.decode_tiles_many(runs, self.plan, group_cb,
                                                   device=self.device)
                fresh: dict[str, dict[int, np.ndarray]] = {}
                for (name, want), vals in zip(pending.items(), values):
                    by_tile = dict(zip(sorted(want), vals))
                    fresh[name] = by_tile
                    decoded += len(by_tile)
                    for tid, v in by_tile.items():
                        self.cache.put(want[tid], v)
                for i, (name, _) in enumerate(items):
                    for tid, v in prep[i].items():
                        if v is None:
                            prep[i][tid] = fresh[name][tid]
            rd_sp.set_tag("tiles_decoded", decoded)
        if stats_cb is not None:
            stats_cb({
                "n_requests": len(items),
                "tiles_requested": requested,
                "tiles_decoded": decoded,
                "cache_hits": hits,
                "cache_misses": misses,
                "cache_evictions": self.cache.evictions - ev0,
            })
        return prep
