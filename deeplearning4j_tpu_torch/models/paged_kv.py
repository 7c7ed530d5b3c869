"""Paged (block) KV cache: allocator, prefix cache, slot session
(counterpart of ``deeplearning4j_tpu/models/paged_kv.py``).

- **PagedKVAllocator** — one physical pool of fixed-size pages per
  model (per attention layer a ``(n_pages, page_size, H, Dh)`` buffer,
  allocated once). Pages are refcounted; a request reserves only the
  pages its ``prompt + n_tokens`` worst case needs, so concurrent slot
  count is bounded by total KV memory, not by per-slot capacity.
  Exhaustion is a typed admission error (``KVPagePoolExhaustedError``,
  HTTP 429 + ``Retry-After``), never an out-of-memory mid-decode.
- **PrefixCache** — prompt-prefix reuse across requests: the pages a
  completed stream's prompt fully covers are registered under their
  page-aligned prefixes; a later prompt that starts with one points its
  page table at the shared (read-only) pages and resumes prefill after
  them. The one write a resumed stream must make inside a shared page
  (re-feeding the last prompt token when the whole prompt was covered)
  is copy-on-write. Entries are LRU-evicted when the allocator runs dry.
- **PagedSlotSession** — the continuous-batching substrate over page
  tables: one (slots, 1) decode step in which each attention layer
  writes its new k/v into the slot's current page, in place, and
  attends through the paged decode kernel (``apply_stream_paged``). On
  a card the step is one CUDA graph, captured at the first step and
  replayed once a step: the port's counterpart of the JAX session's
  ``jax.jit(step, donate_argnums=...)``.

Page id 0 is a reserved scratch page: inactive slots' page-table rows
are all zero, so their dummy writes land in scratch and never touch a
live page. The allocator hands out ids ``1..n_pages``.

Leases (``export_lease`` / ``import_lease``) keep the JAX package's
DKVL wire format byte for byte — magic, header JSON, per-layer page rows
in ``(page_size, H, Dh)`` layout, ``k`` then ``v``, dtype by numpy name,
payload and frame CRCs — so a lease written by either package imports
into the other.
"""

from __future__ import annotations

import json
import struct
import threading
import time
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.observability import compile_watch
from deeplearning4j_tpu_torch.ops import native
from deeplearning4j_tpu_torch.serving.errors import (
    KVLeaseCorruptError, KVLeaseVersionError, KVPagePoolExhaustedError)

__all__ = ["PagedKVAllocator", "PrefixCache", "PagedSlotSession",
           "prefix_fingerprint", "prefix_fingerprints", "parse_lease",
           "LEASE_WIRE_VERSION"]

# the order of a pool's leaves on the wire: jax.tree_util.tree_leaves of
# the JAX package's {"k", "v"} dict (sorted keys)
_LEAVES = ("k", "v")


def _pages_for(tokens: int, page_size: int) -> int:
    return -(-int(tokens) // int(page_size))


# ---------------------------------------------------------------------------
# prefix fingerprints: the router-side half of KV-aware routing
# ---------------------------------------------------------------------------

def _prefix_bytes(tokens, n_tokens: Optional[int] = None) -> bytes:
    arr = np.asarray(tokens).reshape(-1)
    if n_tokens is not None:
        arr = arr[:int(n_tokens)]
    return np.ascontiguousarray(arr, dtype=np.int64).tobytes()


def prefix_fingerprint(tokens, n_tokens: Optional[int] = None) -> str:
    """8-hex digest of a page-aligned token prefix: the same bytes
    :class:`PrefixCache` keys on. A routing hint, not an identity
    check."""
    return format(zlib.crc32(_prefix_bytes(tokens, n_tokens))
                  & 0xFFFFFFFF, "08x")


def prefix_fingerprints(tokens, page_size: int) -> List[Tuple[int, str]]:
    """``[(n_tokens, fingerprint)]`` for every page-aligned prefix of the
    prompt, LONGEST FIRST, computed in one pass with a running crc32."""
    tokens = np.asarray(tokens).reshape(-1)
    ps = int(page_size)
    data = _prefix_bytes(tokens)
    stride = ps * 8                    # int64 bytes per page
    crc = 0
    out = []
    for n in range(1, tokens.size // ps + 1):
        crc = zlib.crc32(data[(n - 1) * stride:n * stride], crc)
        out.append((n * ps, format(crc & 0xFFFFFFFF, "08x")))
    out.reverse()
    return out


# ---------------------------------------------------------------------------
# lease wire format
# ---------------------------------------------------------------------------

_LEASE_MAGIC = b"DKVL"
LEASE_WIRE_VERSION = 1


def parse_lease(blob: bytes) -> Tuple[dict, bytes]:
    """Split and validate a serialized lease: ``(header, payload)``. Bad
    magic / truncation / CRC mismatch raise :class:`KVLeaseCorruptError`;
    an unknown wire version raises :class:`KVLeaseVersionError`.
    Schema-vs-session compatibility is the importing session's job."""
    if not isinstance(blob, (bytes, bytearray, memoryview)):
        raise KVLeaseCorruptError(
            f"lease blob must be bytes, got {type(blob).__name__}")
    blob = bytes(blob)
    if len(blob) < len(_LEASE_MAGIC) + 8 \
            or blob[:len(_LEASE_MAGIC)] != _LEASE_MAGIC:
        raise KVLeaseCorruptError(
            "not a KV lease blob (bad magic or truncated header)")
    frame, tail = blob[:-4], blob[-4:]
    (frame_crc,) = struct.unpack("<I", tail)
    computed = zlib.crc32(frame) & 0xFFFFFFFF
    if computed != frame_crc:
        raise KVLeaseCorruptError(
            f"lease frame CRC mismatch (stored {frame_crc}, computed "
            f"{computed}) — the blob was corrupted in transit")
    (hdr_len,) = struct.unpack_from("<I", frame, len(_LEASE_MAGIC))
    start = len(_LEASE_MAGIC) + 4
    if len(frame) < start + hdr_len:
        raise KVLeaseCorruptError("lease header truncated")
    try:
        header = json.loads(frame[start:start + hdr_len].decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise KVLeaseCorruptError(
            f"lease header is not valid JSON: {e}") from e
    if not isinstance(header, dict):
        raise KVLeaseCorruptError("lease header is not an object")
    version = header.get("version")
    if version != LEASE_WIRE_VERSION:
        raise KVLeaseVersionError(
            f"lease wire version {version!r} != supported "
            f"{LEASE_WIRE_VERSION}")
    payload = frame[start + hdr_len:]
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    if crc != header.get("payload_crc"):
        raise KVLeaseCorruptError(
            f"lease payload CRC mismatch (stored "
            f"{header.get('payload_crc')!r}, computed {crc}) — the blob "
            "was corrupted in transit")
    return header, payload


class PagedKVAllocator:
    """Refcounted free-list allocator over page ids ``1..n_pages`` (id 0
    is the session's scratch page). Thread-safe: admission checks read
    counts from request threads while the batcher worker allocates and
    frees."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._lock = threading.Lock()
        # LIFO free list: recently freed pages are re-used first
        self._free: List[int] = list(range(self.n_pages, 0, -1))
        self._ref = np.zeros(self.n_pages + 1, np.int32)

    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    def in_use(self) -> int:
        return self.n_pages - self.free_count()

    def refcount(self, page: int) -> int:
        with self._lock:
            return int(self._ref[page])

    def alloc(self, n: int, evictor=None) -> List[int]:
        """Allocate ``n`` pages (refcount 1 each). When the free list is
        short and an ``evictor`` is given, it is asked to release the
        shortfall (the prefix cache drops LRU entries); still short
        raises :class:`KVPagePoolExhaustedError` with a backoff hint.
        All or nothing."""
        n = int(n)
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        with self._lock:
            short = n - len(self._free)
        if short > 0 and evictor is not None:
            evictor.evict(short)
        with self._lock:
            if n > len(self._free):
                raise KVPagePoolExhaustedError(
                    f"KV page pool exhausted: {n} pages needed, "
                    f"{len(self._free)} free of {self.n_pages} — active "
                    "decodes free pages as they finish",
                    retry_after_s=max(0.1, 0.02 * n))
            pages = [self._free.pop() for _ in range(n)]
            for p in pages:
                self._ref[p] = 1
            return pages

    def incref(self, pages) -> None:
        with self._lock:
            for p in pages:
                if self._ref[p] <= 0:
                    raise ValueError(
                        f"incref on free page {p} (use-after-free)")
                self._ref[p] += 1

    def decref(self, pages) -> None:
        """Drop one reference per page; a page at refcount 0 returns to
        the free list."""
        with self._lock:
            for p in pages:
                if self._ref[p] <= 0:
                    raise ValueError(
                        f"decref on free page {p} (double free)")
                self._ref[p] -= 1
                if self._ref[p] == 0:
                    self._free.append(p)

    def reset(self) -> None:
        """Forget everything (recovery: the pools were rebuilt, so every
        outstanding reference is dead)."""
        with self._lock:
            self._free = list(range(self.n_pages, 0, -1))
            self._ref[:] = 0


class PrefixCache:
    """Page-granular prompt-prefix index with LRU eviction. Keys are the
    page-aligned token prefixes themselves (exact match): a registered
    prompt of ``m`` full pages adds one entry per prefix length 1..m.
    Each entry owns one refcount on each of its pages; a page frees
    only when no entry and no live slot references it."""

    def __init__(self, allocator: PagedKVAllocator):
        self._alloc = allocator
        self._entries: "OrderedDict[bytes, List[int]]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits_total = 0
        self.evictions_total = 0

    @staticmethod
    def _key(tokens: np.ndarray, n_tokens: int) -> bytes:
        return np.ascontiguousarray(tokens[:n_tokens],
                                    dtype=np.int64).tobytes()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def register(self, tokens, pages: List[int]) -> int:
        """Register the chain of full-prompt pages ``pages`` (page i holds
        tokens ``[i*ps, (i+1)*ps)``). Returns how many entries were
        added."""
        ps = self._alloc.page_size
        tokens = np.asarray(tokens).reshape(-1)
        added = 0
        with self._lock:
            for n in range(1, len(pages) + 1):
                key = self._key(tokens, n * ps)
                if key in self._entries:
                    self._entries.move_to_end(key)
                    continue
                chain = list(pages[:n])
                self._alloc.incref(chain)
                self._entries[key] = chain
                added += 1
        return added

    def lookup(self, tokens) -> List[int]:
        """Longest cached page chain matching the prompt's page-aligned
        prefix. The returned pages carry one NEW reference each (the
        caller's); empty on a miss. Counts a hit when a page matched."""
        ps = self._alloc.page_size
        tokens = np.asarray(tokens).reshape(-1)
        with self._lock:
            for n in range(len(tokens) // ps, 0, -1):
                chain = self._entries.get(self._key(tokens, n * ps))
                if chain is not None:
                    self._entries.move_to_end(self._key(tokens, n * ps))
                    self._alloc.incref(chain)
                    self.hits_total += 1
                    return list(chain)
        return []

    def evict(self, n_pages_needed: int) -> None:
        """Drop LRU entries until ~``n_pages_needed`` page references were
        released (or the cache is empty)."""
        released = 0
        with self._lock:
            while self._entries and released < n_pages_needed:
                _, chain = self._entries.popitem(last=False)
                self._alloc.decref(chain)
                released += len(chain)
                self.evictions_total += 1

    def clear(self) -> None:
        with self._lock:
            for chain in self._entries.values():
                self._alloc.decref(chain)
            self._entries.clear()

    def fingerprints(self, limit: int = 512) -> List[str]:
        """Digests of the (up to ``limit``) most recently used cached
        prefixes, matching :func:`prefix_fingerprint`."""
        with self._lock:
            keys = list(self._entries.keys())
        return [format(zlib.crc32(k) & 0xFFFFFFFF, "08x")
                for k in keys[-int(limit):]]


class _Lease:
    """One admitted stream's page reservation."""

    __slots__ = ("pages", "resume_pos", "prefix_hit_tokens", "prompt_len")

    def __init__(self, pages, resume_pos, prefix_hit_tokens, prompt_len):
        self.pages = pages                    # table order
        self.resume_pos = resume_pos          # first position to feed
        self.prefix_hit_tokens = prefix_hit_tokens
        self.prompt_len = prompt_len


class PagedSlotSession:
    """Continuous-batching decode over a paged KV pool: the sibling of
    :class:`~deeplearning4j_tpu_torch.models.streaming.SlotStreamingSession`
    whose per-slot state is a page table into one shared pool.
    ``capacity`` bounds one request's prompt + generation length (the
    page-table width in tokens); memory is bounded by ``n_pages *
    page_size`` in all.

    The step (:meth:`step_slots`) runs an eager body over static
    buffers: the host writes the page table, the positions and x into
    one pinned staging block, one copy moves it to the device block,
    and the body computes the write indices once (``paged_index``) and
    runs every layer. On a card the first step runs the body and
    captures it into a CUDA graph; every later step is the staging copy
    and one replay. The graph holds the addresses of the pools, the
    static blocks and the net's parameter tensors: pools are only ever
    written in place (steps, ``import_lease``, copy-on-write,
    ``reinit_states``), on the worker thread's current stream, so those
    writes are ordered before the next replay. One graph per session: a
    session is tied to its model's parameters, and a new model version
    gets a new batcher and session, which captures its own graph."""

    @staticmethod
    def supports(net) -> bool:
        """Can this model decode over page tables? False when a layer
        carries state with no paged analog (a recurrent carry or a
        running statistic): the predicate ``kv_mode="auto"`` keys on."""
        return not any(
            not hasattr(layer, "apply_stream_paged")
            and (hasattr(layer, "zero_state")
                 or hasattr(layer, "apply_stream"))
            for layer in net.layers)

    def __init__(self, net, slots: int, capacity: int, page_size: int = 16,
                 n_pages: Optional[int] = None):
        for i, layer in enumerate(net.layers):
            if not hasattr(layer, "apply_stream_paged") and (
                    hasattr(layer, "zero_state")
                    or hasattr(layer, "apply_stream")):
                raise ValueError(
                    f"layer {i} ({type(layer).__name__}) carries state "
                    "with no paged analog (recurrent carry or running "
                    "statistic); use the dense SlotStreamingSession for "
                    "this model")
        self.net = net
        self.device = net.device
        self.slots = int(slots)
        self.capacity = int(capacity)
        self.page_size = int(page_size)
        self.pages_per_slot = _pages_for(capacity, page_size)
        if n_pages is None:
            # memory parity with the dense session by default
            n_pages = self.slots * self.pages_per_slot
        self.allocator = PagedKVAllocator(n_pages, self.page_size)
        self.prefix_cache = PrefixCache(self.allocator)
        self.slot_pos = np.zeros((self.slots,), np.int32)
        self._table = np.zeros((self.slots, self.pages_per_slot), np.int32)
        self._leases: Dict[int, _Lease] = {}
        self._pools = self._fresh_pools()
        # the step's static inputs (built at the first step): a staging
        # block on the host and, on a card, the device block the graph
        # reads; the captured graph, its static output and the launches
        # it holds; the event of the last staging copy; the capture stream
        self._stage: Optional[torch.Tensor] = None
        self._dev: Optional[torch.Tensor] = None
        self._graph = None
        self._graph_out: Optional[torch.Tensor] = None
        self._graph_launches: Dict = {}
        self._copied = None
        self._stream = None

    # ---- pools ----
    def _fresh_pools(self):
        # +1 physical row: page id 0 is the scratch page
        return [layer.zero_page_pool(self.allocator.n_pages + 1,
                                     self.page_size, self.device)
                if hasattr(layer, "apply_stream_paged") else None
                for layer in self.net.layers]

    def pages_total(self) -> int:
        return self.allocator.n_pages

    def pages_in_use(self) -> int:
        return self.allocator.in_use()

    def slot_pages(self, slot: int) -> int:
        lease = self._leases.get(slot)
        return len(lease.pages) if lease is not None else 0

    def slot_prefix_hit(self, slot: int) -> int:
        lease = self._leases.get(slot)
        return lease.prefix_hit_tokens if lease is not None else 0

    # ---- admission-side API (batcher worker thread) ----
    def can_ever_fit(self, prompt_len: int, n_tokens: int) -> bool:
        """Could this request EVER be admitted (table width and whole
        pool permitting)? False means a client error."""
        total = int(prompt_len) + int(n_tokens)
        return (total <= self.capacity
                and _pages_for(total, self.page_size)
                <= self.allocator.n_pages)

    def reserve(self, prompt, n_tokens: int) -> _Lease:
        """Reserve pages for one stream's ``prompt + n_tokens`` worst
        case, reusing cached prefix pages when the prompt matches.
        Raises :class:`KVPagePoolExhaustedError` (all or nothing) under
        transient pressure. The lease is not visible to the device until
        :meth:`bind`."""
        prompt = np.asarray(prompt).reshape(-1)
        T0 = prompt.size
        if T0 < 1:
            raise ValueError("prompt must contain at least one token")
        if T0 + int(n_tokens) > self.capacity:
            raise ValueError(
                f"prompt ({T0}) + n_tokens ({n_tokens}) exceeds the "
                f"page-table width (capacity {self.capacity})")
        total_pages = _pages_for(T0 + int(n_tokens), self.page_size)
        shared = self.prefix_cache.lookup(prompt)
        # the LAST prompt token is re-fed for the first output, so a hit
        # covers at most T0 - 1 positions
        resume = min(len(shared) * self.page_size, T0 - 1)
        cow_idx = resume // self.page_size
        need_cow = cow_idx < len(shared)
        fresh_needed = total_pages - len(shared) + (1 if need_cow else 0)
        try:
            fresh = self.allocator.alloc(fresh_needed,
                                         evictor=self.prefix_cache)
        except KVPagePoolExhaustedError:
            if shared:
                self.allocator.decref(shared)
            raise
        if need_cow:
            # the resume position is INSIDE a shared page (the whole
            # prompt was covered): copy it so the re-fed token's write
            # cannot touch the shared original
            cow_page = fresh.pop()
            self._device_copy_page(cow_page, shared[cow_idx])
            self.allocator.decref([shared[cow_idx]])
            shared = shared[:cow_idx] + [cow_page]
        return _Lease(shared + fresh, resume, prefix_hit_tokens=resume,
                      prompt_len=T0)

    def bind(self, slot: int, lease: _Lease) -> None:
        self._table[slot, :] = 0
        self._table[slot, :len(lease.pages)] = lease.pages
        self.slot_pos[slot] = lease.resume_pos
        self._leases[slot] = lease

    def release(self, slot: int, register_prompt=None) -> None:
        """Recycle a slot: drop its page references; when the stream
        completed cleanly, first register its full-prompt pages in the
        prefix cache (the cache takes its own references)."""
        lease = self._leases.pop(slot, None)
        self._table[slot, :] = 0
        self.slot_pos[slot] = 0
        if lease is None:
            return
        if register_prompt is not None:
            prompt = np.asarray(register_prompt).reshape(-1)
            n_full = prompt.size // self.page_size
            if n_full > 0:
                self.prefix_cache.register(prompt, lease.pages[:n_full])
        self.allocator.decref(lease.pages)

    def release_all(self) -> None:
        for slot in list(self._leases):
            self.release(slot)

    def register_written_prefix(self, slot: int, prompt) -> int:
        """Donate the slot's FULLY-WRITTEN prompt pages to the prefix
        cache without releasing the lease. Returns how many pages were
        registered."""
        lease = self._leases.get(slot)
        if lease is None:
            return 0
        pos = int(self.slot_pos[slot])
        prompt = np.asarray(prompt).reshape(-1)
        n_full = min(pos, prompt.size) // self.page_size
        if n_full > 0:
            self.prefix_cache.register(prompt, lease.pages[:n_full])
        return n_full

    # ---- lease serialization (the DKVL wire format) ----
    def _pool_schema(self) -> List[Optional[List[dict]]]:
        """Per-layer leaf schema (page-row shape + numpy dtype name): what
        two replicas must agree on for a lease to be portable. None for
        stateless layers."""
        schema: List[Optional[List[dict]]] = []
        for pool in self._pools:
            if pool is None:
                schema.append(None)
                continue
            schema.append([{"shape": list(pool[n].shape[1:]),
                            "dtype": str(np.dtype(str(pool[n].dtype)
                                                  .replace("torch.", "")))}
                           for n in _LEAVES])
        return schema

    def export_lease(self, slot: int, extra: Optional[dict] = None) -> bytes:
        """Serialize slot ``slot``'s attention state: a versioned header
        (wire version, page size, position, per-layer pool schema, the
        caller's ``extra``) followed by the raw contents of every page
        the stream has written, CRC-tagged. The slot is left as it is."""
        lease = self._leases.get(slot)
        if lease is None:
            raise ValueError(f"slot {slot} holds no lease to export")
        pos = int(self.slot_pos[slot])
        # only pages with WRITTEN positions travel: [0, pos)
        pages_written = _pages_for(pos, self.page_size) if pos else 0
        ids = torch.as_tensor(lease.pages[:pages_written], dtype=torch.long,
                              device=self.device)
        chunks: List[bytes] = []
        for pool in self._pools:
            if pool is None:
                continue
            for name in _LEAVES:
                # (pages, page_size, H, Dh) rows, page after page
                chunks.append(np.ascontiguousarray(
                    pool[name][ids].cpu().numpy()).tobytes())
        payload = b"".join(chunks)
        header = {
            "version": LEASE_WIRE_VERSION,
            "page_size": self.page_size,
            "pos": pos,
            "pages_written": pages_written,
            "layers": self._pool_schema(),
            "payload_crc": zlib.crc32(payload) & 0xFFFFFFFF,
            "extra": dict(extra or {}),
        }
        hdr = json.dumps(header).encode()
        frame = _LEASE_MAGIC + struct.pack("<I", len(hdr)) + hdr + payload
        # trailing frame CRC over everything, header included
        return frame + struct.pack("<I", zlib.crc32(frame) & 0xFFFFFFFF)

    def import_lease(self, blob: bytes,
                     total_tokens: int) -> Tuple[_Lease, dict]:
        """Rebuild an exported lease into THIS session's pool: validate
        the blob (magic/CRC -> :class:`KVLeaseCorruptError`; wire version
        / page size / pool schema skew -> :class:`KVLeaseVersionError`),
        reserve ``total_tokens``' worth of fresh pages (all or nothing,
        the prefix cache evicted under pressure), and write the payload
        pages into the pools: the same bytes at the same in-page
        positions. Returns ``(lease, extra)``; bind it like any
        reservation."""
        header, payload = parse_lease(blob)
        try:
            page_size = int(header["page_size"])
            pos = int(header["pos"])
            pages_written = int(header["pages_written"])
            layers = header["layers"]
        except (KeyError, TypeError, ValueError) as e:
            raise KVLeaseCorruptError(
                f"lease header field missing or malformed: {e!r}") from e
        if page_size != self.page_size:
            raise KVLeaseVersionError(
                f"lease page_size {page_size} != this session's "
                f"{self.page_size}")
        schema = self._pool_schema()
        if layers != schema:
            raise KVLeaseVersionError(
                "lease pool schema does not match this model's attention "
                "layers (different model or dtype)")
        if pos < 0 or pages_written != _pages_for(pos, self.page_size):
            raise KVLeaseCorruptError(
                f"lease header inconsistent: pos {pos} does not need "
                f"{pages_written} page(s) of {self.page_size} tokens")
        if pos > int(total_tokens):
            raise KVLeaseCorruptError(
                f"lease position {pos} exceeds the request's token budget "
                f"{total_tokens}")
        leaf_bytes = [np.dtype(d["dtype"]).itemsize * int(np.prod(d["shape"]))
                      for s in schema if s is not None for d in s]
        expect = sum(leaf_bytes) * pages_written
        if len(payload) != expect:
            raise KVLeaseCorruptError(
                f"lease payload is {len(payload)} bytes; schema demands "
                f"{expect} ({len(leaf_bytes)} pool leaves x "
                f"{pages_written} pages)")
        fresh = self.allocator.alloc(_pages_for(total_tokens,
                                                self.page_size),
                                     evictor=self.prefix_cache)
        try:
            ids = torch.as_tensor(fresh[:pages_written], dtype=torch.long,
                                  device=self.device)
            off = 0
            with torch.inference_mode():
                for i, pool in enumerate(self._pools):
                    if pool is None:
                        continue
                    for name, spec in zip(_LEAVES, schema[i]):
                        dtype = np.dtype(spec["dtype"])
                        n = pages_written * int(np.prod(spec["shape"]))
                        rows = np.frombuffer(payload, dtype=dtype, count=n,
                                             offset=off).reshape(
                            (pages_written, *spec["shape"]))
                        off += n * dtype.itemsize
                        pool[name][ids] = torch.from_numpy(rows.copy()).to(
                            self.device)
        except BaseException:
            self.allocator.decref(fresh)
            raise
        lease = _Lease(fresh, pos, prefix_hit_tokens=0, prompt_len=pos)
        return lease, dict(header.get("extra") or {})

    # ---- device step ----
    def _device_copy_page(self, dst: int, src: int) -> None:
        """Copy page ``src``'s rows onto page ``dst`` in every pool, in
        place (copy-on-write)."""
        with torch.inference_mode():
            for pool in self._pools:
                if pool is not None:
                    for name in _LEAVES:
                        pool[name][dst].copy_(pool[name][src])

    def step_slots(self, x, active) -> torch.Tensor:
        """One decode step for every slot at once: ``x`` is (slots, 1,
        C) host data, free slots carry a dummy row (their write lands in
        the scratch page and their ``pos`` stays put). Returns the
        (slots, 1, V) output for the new step. On a card the step
        replays the session's CUDA graph (captured at the first step)
        and the returned tensor is the graph's static output: read it
        before the next step overwrites it. A failed capture or replay
        raises; nothing falls back to the eager body."""
        return self._step(x, active, graphed=self.device.type == "cuda")

    def _step_eager(self, x, active) -> torch.Tensor:
        """:meth:`step_slots` through the eager body, never the graph:
        the reference the card tests and ``chip_smoke.py`` hold the
        replayed step against."""
        return self._step(x, active, graphed=False)

    def _step(self, x, active, graphed: bool) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        x = np.asarray(x, np.float32)
        active = np.asarray(active, bool)
        if x.ndim != 3 or x.shape[0] != self.slots or x.shape[1] != 1:
            raise ValueError(f"x has {x.shape[0] if x.ndim else 0} rows "
                             f"of shape {x.shape[1:]}; session has "
                             f"{self.slots} slots of (1, C)")
        if active.any() and int(self.slot_pos[active].max()) >= \
                self.capacity:
            raise ValueError(
                f"slot overflow: an active slot is at pos "
                f"{int(self.slot_pos[active].max())} with capacity "
                f"{self.capacity} — admit shorter requests or build the "
                "session with a larger capacity")
        # inactive slots step at pos 0 over their all-zero table row: the
        # write targets scratch, never a live page
        self._stage_inputs(x, np.where(active, self.slot_pos, 0))
        if not graphed:
            out = self._body(self._dev)
        elif self._graph is None:
            out = self._capture()
        else:
            self._graph.replay()
            native.count_replay(self._graph_launches)
            compile_watch.record_replay()
            out = self._graph_out
        self.slot_pos = self.slot_pos + active.astype(self.slot_pos.dtype)
        return out

    def _views(self, buf):
        """(table (slots, P) int32, pos (slots,) int32, x (slots, 1, C)
        float32) over one staged block of int32s."""
        S, P = self.slots, self.pages_per_slot
        return (buf[:S * P].view(S, P), buf[S * P:S * (P + 1)],
                buf[S * (P + 1):].view(torch.float32).view(S, 1, -1))

    def _stage_inputs(self, x, pos) -> None:
        """Write the step's host inputs (the page table, the positions,
        x) into the staging block, then, on a card, into the static
        device block the graph reads: one copy from pinned memory, on
        the current stream, before the replay on that stream."""
        S, P = self.slots, self.pages_per_slot
        n = S * (P + 1) + x[:, 0].size
        cuda = self.device.type == "cuda"
        if self._stage is None:
            self._stage = torch.zeros(n, dtype=torch.int32, pin_memory=cuda)
            self._dev = (torch.zeros(n, dtype=torch.int32,
                                     device=self.device)
                         if cuda else self._stage)
        elif self._stage.numel() != n:
            raise ValueError(f"x rows have {x[:, 0].size} features; this "
                             "session's steps were built for "
                             f"{self._stage.numel() - S * (P + 1)}")
        if self._copied is not None:
            # the last step's copy must have read the staging block
            self._copied.synchronize()
        st = self._stage.numpy()
        st[:S * P] = self._table.reshape(-1)
        st[S * P:S * (P + 1)] = pos
        st[S * (P + 1):].view(np.float32)[:] = x.reshape(-1)
        if cuda:
            self._dev.copy_(self._stage, non_blocking=True)
            if self._copied is None:
                self._copied = torch.cuda.Event()
            self._copied.record()

    def _body(self, dev) -> torch.Tensor:
        """The step's eager body over the static block ``dev``: the
        indices once (:func:`paged_index`), then every layer. What the
        graph captures; on the CPU it is the step."""
        from deeplearning4j_tpu_torch.nn.conf.layers.attention import (
            paged_index)
        table, pos, x = self._views(dev)
        host_pos = self._views(self._stage)[1]
        params, states = self.net.params, self.net.state
        with torch.inference_mode():
            idx = paged_index(table, pos, 1, self.page_size,
                              host_pos=host_pos)
            h = x
            for i, layer in enumerate(self.net.layers):
                if self._pools[i] is not None:
                    h, _ = layer.apply_stream_paged(
                        params[i], self._pools[i], table, idx, h)
                else:
                    h, _ = layer.apply(params[i], states[i], h,
                                       training=False)
        return h

    def _capture(self) -> torch.Tensor:
        """The first step on the card: run the eager body once on the
        session's own stream (its output is this step's: the run also
        warms what a capture must not do lazily, such as cuBLAS's
        workspace for that stream), then capture the body into a CUDA
        graph on that stream. Capture is thread-local, so other threads
        (HTTP handlers, other replicas' workers) keep launching on the
        card meanwhile. The launches the capture recorded are counted on
        every replay. Raises if the capture fails."""
        t0 = time.perf_counter()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self._stream):
            out = self._body(self._dev)
            with native.capture_launches() as tally:
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    static = self._body(self._dev)
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass          # the capture was invalidated
                    raise
                graph.capture_end()
        current.wait_stream(self._stream)
        self._graph, self._graph_out = graph, static
        self._graph_launches = tally
        compile_watch.record_capture(time.perf_counter() - t0)
        return out

    def reinit_states(self) -> None:
        """Recovery after a failed step, which may have written some
        layers' pages and not others: zero the pools IN PLACE (a captured
        graph keeps their addresses) AND forget every page reference.
        The prefix cache's entries point at contents that no longer
        exist, so it flushes (its counters survive)."""
        self._leases.clear()
        self.prefix_cache.clear()
        self.allocator.reset()
        self.slot_pos[:] = 0
        self._table[:] = 0
        with torch.inference_mode():
            for pool in self._pools:
                if pool is not None:
                    for name in _LEAVES:
                        pool[name].zero_()
