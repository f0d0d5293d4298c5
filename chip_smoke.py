#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``csnappy_tpu_torch``) on one H100.

    python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout, then, in order:

1. build   — every native source, one compiler each, all started together;
2. decode  — ``decode_blocks`` on B=64 blocks of urls.10K (32 KiB each, as
             bench.py makes them) and on malformed and error-priority
             vectors at four output limits; ``decode_segments`` on
             urls.10K.snappy's body.  Each kernel result must equal the plain
             version run on CPU copies: every output byte, ``produced`` and
             ``status`` (exact: bytes have no tolerance);
3. encode  — ``encode_blocks`` on the same B=64 x 32 KiB batch, equal byte
             for byte to the plain version, and ``compress_np(urls.10K)``
             byte-identical to the JAX package's stream (the committed
             fixture, 354,567 B);
4. main path — with every launch count set to 0, through the entry points a
             user calls (device=None, so the card): ``encode_blocks`` and
             ``decode_blocks`` on the B=64 batch from host arrays,
             ``api.compress(urls.10K)`` equal to the fixture,
             ``api.decompress(urls.10K.snappy)`` equal to urls.10K, a 32 KiB
             fragment and the unaligned vector round-trip; every kernel of
             the path must have launched;
5. times   — median of 20 CUDA-event-timed launches after warm-up for each
             kernel at the main path's shapes (inputs resident in L2), the
             plain version's time on the host, and the bound: the larger of
             the bytes the function must move over 3.35 TB/s and one
             operation per byte over 67 TOP/s (H100 SXM data sheet).  The
             serial chain (tags or commits of the longest block) is counted
             and printed beside it;
6. whole streams — on every stream of ``tests/data/torch_ref/streams.npz``:
             ``scan_segments.cu`` equal to its plain walk and to the JAX
             scan (``seg``, ``meta``), ``decode_ws`` bytes-or-None equal to
             the JAX pipeline's, ``decode_stream.cu`` equal to its plain
             version at the exact limit, 5000 below it and at a multiple of
             32768, and to the JAX kernel, ``decode_jnp``'s torch ops on the
             card equal to the CPU and to the JAX decoder; then the main path
             of the slice with its launch counts set to 0: ``api.decompress``
             of urls.10K.snappy and of a 16 MiB stream (urls.10K x 24, compressed
             on the card) through ``decode_ws`` with no host scan, of the
             unaligned vector through ``decode_stream`` and of a COPY_4
             offset-40000 stream through ``decode_jnp``, and urls.10K.snappy
             once more with ``decode_ws`` answering None, through the host
             scan to one ``decode_segments`` launch and no ``decode_jnp``
             (a disagreeing segment decoder raises on the card); then times on the
             702 KB and 16 MiB streams (each kernel, the host scan, the whole
             ``decode_ws`` pipeline);
7. container — ``tools/zramsim.run`` over a 256 MiB tree (the port's
             corpus files, urls.10K among them, copied under subdirectories up
             to 268,435,456 B) at 4 KiB pages on the card, with md5 readback of
             every file and the launch counts of ``encode_blocks`` and
             ``decode_blocks`` set to 0 before it; the first 64 pages of each
             corpus file equal to the plain versions' container; every
             stored page decoded by the port's host decoder
             (``native.decompress_noheader``) to its input page; the zram record
             on a JSON line of its own (``{"zram": ...}``): sizes, ratio, codec
             seconds and GB/s of compress and decompress, host seconds;
8. container fixture — the port's container on the card equal to the JAX
             fixture (``tests/data/torch_ref/container.npz``) byte for byte, with
             equal stats, and the malformed containers' error codes;
9. cli     — ``python -m csnappy_tpu_torch.cli`` in subprocesses on the card:
             ``file -c``/``-d`` of urls.10K, ``-d`` of urls.10K.snappy,
             ``-S c``/``-S d``, ``block -c``/``-d`` at 4 KiB; exit 0 and the
             right bytes;
10. movebench — rows 12-13 (the flat gather, ``lane_gather`` of
             ``csrc/primitives.cu`` with one row, and the max-scan of
             ``csrc/movebench.cu``) against their plain versions at
             n = 32768 and 2^24 with 0 differing elements, timed beside the
             kernel's own device time (``device_ms``, from torch.profiler),
             the library call (``tbl.view(-1)[idx]``, ``torch.cummax``) and
             the bound (12n and 8n bytes over 3.35 TB/s); then
             ``movebench.main()`` with their launch counts set to 0, printing
             its five strategy lines;
11. primitives — rows 6-11 (``csrc/primitives.cu``: ``lane_gather``,
             ``scatter_or``, ``compose_round``, ``row_gather``): with their
             six launch counts set to 0, each wrapper of ``ops/primitives.py``
             once with device=None on the main path's batch (B=64 blocks of
             32 KiB as int32 [64, 256, 128];
             ``movebench.primitive_inputs``), every count moved; each result
             equal to the plain version on CPU copies and every case of
             ``tests/data/torch_ref/primitives.npz`` equal to the JAX Pallas
             kernels' answer (0 differing elements); times beside the
             kernel's own device time (``device_ms``), the plain version,
             the bound (bytes over 3.35 TB/s) and the library call where one
             PyTorch call computes the function (``torch.gather``,
             ``Tensor.scatter_reduce``, ``torch.index_select``,
             ``torch.take``, given in-range int64 indices);
12. probes — rows 14a-14i (``csrc/probe.cu``, ``csrc/probe3.cu``,
             ``csrc/probe4.cu``, ``tools/probe.py``): with every
             count of ``probe.launches`` set to 0, ``probe.measure`` of each
             kernel of ``probe.TIMED`` (probes that share an entry, as
             mosaic_probe6's four gathers do, once) and the capacity probe on
             the card (device=None): ns and SM cycles per iteration from the slope
             between k_lo and k_hi (CUDA events, and ``clock64()`` inside the
             kernel), its output at k_hi equal to the plain version, the
             shared-memory capacity in bytes by bisection; every count moved;
             then each probe at every K of ``tests/data/torch_ref/probes.npz``
             (and on its constructed inputs) equal to the JAX probes' answers
             and to the plain version (0 differing elements), and the
             resolve-phase gathers at ``probe.WRAP_K``, past the int32 wrap of
             their sum, equal to the plain version; one ``kernels`` row per
             ``pl.pallas_call`` site (nine) with its probes' times as a
             sub-list (``mosaic_probe6.taa_4096x128`` listed as failing to
             trace in JAX); then each serial chain of phases 5 and 6 in units
             of one measured ``walk_smem`` step (a dependent shared load and
             four integer operations: a yardstick, not a floor; printed only,
             never in the ``kernels`` line);
13. kernel_lib — rows 15a-15b (``csrc/kernel_lib.cu`` over
             ``csrc/kernel_lib.cuh``, ``ops/kernel_lib.py``): with every count
             of ``kernel_lib.launches`` set to 0, each helper of
             ``kernel_lib.HELPERS`` on every case of
             ``tests/data/torch_ref/kernel_lib.npz`` on the card (device=None),
             equal to the JAX helpers' answers and to the plain version (0
             differing elements); every count moved; a call of each helper on
             its first case and the PyTorch call that computes the same
             function inside the contract, where there is one, timed in
             ``KL_ROUNDS`` interleaved rounds (median and spread), beside its
             kernel's own device time, the plain version and the bound
             (``kernel_lib.traffic``: what the helper reads on that case); one
             ``kernels`` row for each of the two ``pl.pallas_call`` sites with
             its helpers as a sub-list; ``scatter_rows_multi`` at the JAX
             fused kernels' three shapes (the fixture's ``srm_dec_co256``,
             ``srm_stream_co256_t3``, ``srm_enc_ocr304_t3``) timed the same way
             beside one ``index_add_`` over the stacked tables, with each
             case's launches in the main-path run; and the host split of one
             call of each scatter, step by step;
14. the ``kernels`` JSON line, the card's name and power limit, and the
   result line.

Any failure raises and exits non-zero; with no card, or without the
package beside this script, it exits non-zero before printing a result.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"
KL_ROUNDS = 5                   # phase 13's interleaved timing rounds
B, BS = 64, 32768             # the main path's batch: 64 blocks of 32 KiB


def _host_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _tags(frag: bytes) -> tuple[int, int]:
    """(tags, copies) of a valid headerless stream."""
    ip = tags = copies = 0
    while ip < len(frag):
        tag = frag[ip]
        kind = tag & 3
        tags += 1
        if kind == 0:
            u = tag >> 2
            nb = max(0, u - 59)
            ln = int.from_bytes(frag[ip + 1 : ip + 1 + nb], "little") + 1 if nb else u + 1
            ip += 1 + nb + ln
        else:
            copies += 1
            ip += (2, 3, 5)[kind - 1]
    return tags, copies


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _same(name, got, want) -> int:
    """Hold a kernel's (out, produced, status) against the plain version's;
    returns the largest absolute byte difference (must be 0)."""
    out, prod, st = (t.cpu() for t in got)
    pout, pprod, pst = want
    if not (prod == pprod).all() or not (st == pst).all():
        bad = (prod != pprod) | (st != pst)
        raise AssertionError(f"{name}: produced/status differ at blocks "
                             f"{bad.nonzero().reshape(-1).tolist()[:10]}")
    err = int((out.int() - pout.int()).abs().max()) if out.numel() else 0
    if err:
        raise AssertionError(f"{name}: output bytes differ (max abs err {err})")
    return err


def _pack(torch, frags):
    arr = torch.zeros((len(frags), max(len(f) for f in frags)), dtype=torch.uint8)
    for i, f in enumerate(frags):
        arr[i, : len(f)] = torch.frombuffer(bytearray(f), dtype=torch.uint8)
    return arr, torch.tensor([len(f) for f in frags], dtype=torch.int32)


def _bound(nbytes: int) -> tuple[float, str]:
    """Least time for a function that moves ``nbytes`` and does one operation a byte."""
    from csnappy_tpu_torch.tools.timing import HBM_BYTES_PER_S, OPS_PER_S

    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, nbytes / OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _whole_stream(torch, np, dev, urls: bytes, golden: bytes, unaligned: bytes, card: str):
    """Phase 6: the whole-stream slice (scan_segments.cu, decode_stream.cu,
    decode_jnp's torch ops) against its plain versions and the JAX fixture,
    the API's whole-stream routes with launch counts, and times."""
    from csnappy_tpu_torch import api
    from csnappy_tpu_torch.models import wire
    from csnappy_tpu_torch.ops import decode_fused, decode_jnp, decode_stream, decode_ws
    from csnappy_tpu_torch.runtime import native
    from csnappy_tpu_torch.tools.timing import time_ms

    def u8(b: bytes):
        return torch.frombuffer(bytearray(b), dtype=torch.uint8)

    def err(a, b) -> int:
        """Largest absolute difference of two byte tensors of one length (0 if empty)."""
        assert a.numel() == b.numel()
        return int((a.cpu().int() - b.cpu().int()).abs().max()) if a.numel() else 0

    def sha(b: bytes) -> list:
        return list(hashlib.sha256(b).digest())

    z = np.load(DATA / "torch_ref" / "streams.npz")
    errs = {"scan_segments": 0, "decode_stream": 0, "decode_jnp": 0}
    nstream = 0
    for i, name in enumerate(str(s) for s in z["names"]):
        body, dst = z["body"][z["offs"][i] : z["offs"][i + 1]].tobytes(), int(z["dst_len"][i])
        nseg = -(-dst // BS)
        bdev = u8(body).to(dev)
        seg, meta = decode_ws.scan_segments(bdev, nseg + 1, dev)
        pseg, pmeta = decode_ws.scan_plain(u8(body), nseg + 1)
        errs["scan_segments"] = max(errs["scan_segments"], int((seg.cpu() - pseg).abs().max()),
                                    int((meta[:3].cpu() - pmeta[:3]).abs().max()))
        if decode_ws.plan(len(body), dst) is not None:      # the JAX scan's seg[:nseg], meta[:3]
            want = z["ws_seg"][z["ws_seg_offs"][i] : z["ws_seg_offs"][i + 1]]
            assert seg[:nseg].cpu().numpy().tolist() == want.tolist(), name
            assert meta[:3].cpu().numpy().tolist() == z["ws_meta"][i].tolist(), name
        res = decode_ws.decompress_noheader_ws(bdev, dst, dev)
        assert (res is not None) == bool(z["ws_bytes"][i]), name
        assert res is None or sha(res) == z["ws_sha"][i].tolist(), name
        for cap in sorted({dst, max(0, dst - 5000), dst // BS * BS}):
            got = decode_stream.decode_stream(bdev, cap, dev)
            want = decode_stream.decode_stream(body, cap, "cpu")
            p = int(want[1])
            assert (int(got[1]), int(got[2])) == (p, int(want[2])), (name, cap)
            errs["decode_stream"] = max(errs["decode_stream"], err(got[0][:p], want[0][:p]))
            nstream += 1
            if cap == dst:
                assert (p, int(got[2])) == (z["st_prod"][i], z["st_status"][i]), name
                assert sha(got[0][:p].cpu().numpy().tobytes()) == z["st_sha"][i].tolist(), name
        jg = decode_jnp.decompress_noheader_np(bdev, dst, dev)
        jc = decode_jnp.decompress_noheader_np(body, dst, "cpu")
        assert jg[1:] == jc[1:] == (z["jnp_prod"][i], z["jnp_status"][i]), name
        assert sha(jg[0].tobytes()) == z["jnp_sha"][i].tolist(), name
        errs["decode_jnp"] = max(errs["decode_jnp"], err(torch.from_numpy(jg[0]), torch.from_numpy(jc[0])))
    torch.cuda.synchronize()
    assert not any(errs.values()), errs
    print(f"[stream] {len(z['names'])} fixture streams: scan_segments (seg, meta) equal to plain "
          f"and to the JAX scan; decode_ws bytes-or-None equal to the JAX pipeline; "
          f"decode_stream equal to plain ({nstream} limits: exact, -5000, multiple of 32768) "
          f"and to the JAX kernel; decode_jnp on the card equal to the CPU and the JAX decoder; "
          f"max abs err {errs}", flush=True)

    # main path: every whole-stream route through the API, counts at 0 first
    big = urls * 24                                   # 16.85 MB, 515 segments
    big_comp = api.compress(big)
    lit = bytes(range(256)) * 160
    far = bytearray()
    wire.emit_literal(far, lit)
    far += bytes([wire.TAG_COPY_4 | ((8 - 1) << 2)]) + (40000).to_bytes(4, "little")
    counted = {"scan_segments": decode_ws.scan_segments,
               "decode_segments": decode_fused.decode_segments,
               "decode_stream": decode_stream.decode_stream,
               "decode_jnp": decode_jnp.decompress_noheader_np}
    host_scan = native.scan_segments
    host_calls = []
    native.scan_segments = lambda *a, **k: host_calls.append(1) or host_scan(*a, **k)
    routes = {}

    def via_host_scan(stream: bytes) -> bytes:
        """The host-scan segmentable route: decode_ws answers None, so the
        host scan routes the stream to one decode_segments launch."""
        ws = decode_ws.decompress_noheader_ws
        decode_ws.decompress_noheader_ws = lambda *a, **k: None
        try:
            return api.decompress(stream)
        finally:
            decode_ws.decompress_noheader_ws = ws
    try:
        for w in counted.values():
            w.launches = 0
        for route, fn, want in (
                ("urls.10K.snappy", lambda: api.decompress(golden), urls),
                ("unaligned_uint64_test.snappy", lambda: api.decompress(
                    (DATA / "unaligned_uint64_test.snappy").read_bytes()), unaligned),
                ("copy4_offset_40000", lambda: api.decompress_noheader(bytes(far), len(lit) + 8),
                 lit + lit[-40000 : -40000 + 8]),
                ("urls.10K x24", lambda: api.decompress(big_comp), big),
                ("urls.10K.snappy via the host scan", lambda: via_host_scan(golden), urls)):
            before = {k: w.launches for k, w in counted.items()}
            nhost = len(host_calls)
            assert fn() == want, route
            routes[route] = {k: w.launches - before[k] for k, w in counted.items()
                             if w.launches > before[k]}
            routes[route]["host_scan"] = len(host_calls) - nhost
    finally:
        native.scan_segments = host_scan
    launches = {k: w.launches for k, w in counted.items()}
    assert all(n > 0 for n in launches.values()), launches
    for route in ("urls.10K.snappy", "urls.10K x24"):
        assert routes[route] == {"scan_segments": 1, "decode_segments": 1, "host_scan": 0}, routes
    assert routes["urls.10K.snappy via the host scan"] == {"decode_segments": 1, "host_scan": 1}, \
        routes
    assert routes["unaligned_uint64_test.snappy"].get("decode_stream") == 1, routes
    assert routes["copy4_offset_40000"].get("decode_jnp") == 1, routes
    print(f"[stream-main] api whole-stream routes on the card: {routes}; launches {launches}",
          flush=True)

    # times: the 702 KB reference stream and the 16 MiB stream
    rows = {}
    for label, stream, dst in (("702KB", golden, len(urls)), ("16MiB", big_comp, len(big))):
        body = stream[wire.varint_decode(stream)[1]:]
        nseg = -(-dst // BS)
        bdev, bcpu = u8(body).to(dev), u8(body)
        reps = 20 if label == "702KB" else 5
        tags = int(decode_ws.scan_plain(bcpu, nseg + 1)[1][3])     # the whole chain: every tag
        comp = torch.nn.functional.pad(bdev.int(), (0, decode_jnp._bucket(len(body)) - len(body)))
        ms = {"scan_segments": time_ms(lambda: decode_ws.scan_segments(bdev, nseg + 1, dev),
                                        n=reps),
              "decode_stream": time_ms(lambda: decode_stream.decode_stream(bdev, dst, dev),
                                        n=reps),
              "decode_jnp": time_ms(lambda: decode_jnp._decode_core(
                  comp, len(body), dst, decode_jnp._bucket(dst)), n=reps)}
        host_ms = statistics.median(_host_ms(lambda: native.scan_segments(body, dst, BS))
                                    for _ in range(5))
        ws_ms = statistics.median(_host_ms(lambda: decode_ws.decompress_noheader_ws(bdev, dst, dev))
                                  for _ in range(5))
        print(f"[times] {label} stream ({len(body)} B in, {dst} B out, {nseg} segments, {tags} "
              f"tags): scan_segments {ms['scan_segments']:.4f} ms on the card, host "
              f"native.scan_segments {host_ms:.4f} ms; decode_ws pipeline {ws_ms:.4f} ms host clock "
              f"({dst / ws_ms / 1e6:.3f} GB/s of output)", flush=True)
        for name, route, src, replaces, nbytes in (
                ("scan_segments", "cuda", "csnappy_tpu_torch/csrc/scan_segments.cu",
                 "csnappy_tpu/ops/decode_ws.py:268", len(body) + 4 * (nseg + 1) + 32),
                ("decode_stream", "cuda", "csnappy_tpu_torch/csrc/decode_stream.cu",
                 "csnappy_tpu/ops/decode_stream.py:531", len(body) + dst + 16),
                ("decode_jnp", "torch-ops", "csnappy_tpu_torch/ops/decode_jnp.py",
                 "csnappy_tpu/ops/decode_jnp.py:184", len(body) + dst)):
            bound_ms, bound_by = _bound(nbytes)
            print(f"[times] {label} {name}: {ms[name]:.4f} ms, bound {bound_ms:.5f} ms by "
                  f"{bound_by} ({nbytes} B), serial chain {tags} tags, {launches[name]} "
                  f"launches on the main path", flush=True)
            if label == "702KB":
                plain = {"scan_segments": lambda: decode_ws.scan_plain(bcpu, nseg + 1),
                         "decode_stream": lambda: decode_stream.decode_stream(bcpu, dst, "cpu"),
                         "decode_jnp": lambda: decode_jnp.decompress_noheader_np(bcpu, dst, "cpu")}
                rows[name] = {"name": name, "route": route, "source": src, "replaces": replaces,
                              "launches": launches[name], "max_abs_err": errs[name],
                              "ms": ms[name], "plain_ms": _host_ms(plain[name]),
                              "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                              "bytes": nbytes, "chain_steps": tags}
            else:
                rows[name].update(ms_16MiB=ms[name], bound_ms_16MiB=bound_ms, chain_steps_16MiB=tags)
        key = "" if label == "702KB" else "_16MiB"
        rows["scan_segments"].update({f"host_scan_ms{key}": host_ms, f"decode_ws_ms{key}": ws_ms})
    print(f"[times] card {card}", flush=True)
    return list(rows.values())


ZRAM_BYTES = 256 << 20         # the [container] tree: 65,536 pages of 4 KiB
PAGE = 4096


def _container(torch, np, dev, card: str) -> dict:
    """Phase 7: ``zramsim.run`` over a 256 MiB tree of 4 KiB pages on the
    card with md5 readback; the first 64 pages of each corpus file equal to
    the plain versions; every stored page checked with the host decoder;
    the zram record.  Returns the container path's launch counts."""
    import os
    import tempfile

    from csnappy_tpu_torch.ops import decode_fused, encode_fused
    from csnappy_tpu_torch.runtime import container, native
    from csnappy_tpu_torch.tools import corpus, zramsim

    files = sorted(corpus.corpus().items())
    assert "urls.10K" in dict(files), "corpus without tests/data/urls.10K"
    seen, stats = [], {"c": [], "d": []}
    compress, decompress = container.compress_blocks, container.decompress_blocks

    def compress_seen(data, *a, **k):
        cont, st = compress(data, *a, **k)
        seen.append((data, cont))
        stats["c"].append(st)
        return cont, st

    def decompress_seen(*a, **k):
        out, st = decompress(*a, **k)
        stats["d"].append(st)
        return out, st

    with tempfile.TemporaryDirectory(prefix="zram_tree_") as root:
        written, copy = 0, 0
        while written < ZRAM_BYTES:
            sub = os.path.join(root, f"copy{copy:03d}")
            os.makedirs(sub)
            for name, data in files:
                part = data[: ZRAM_BYTES - written]
                if not part:
                    break
                with open(os.path.join(sub, name), "wb") as f:
                    f.write(part)
                written += len(part)
            copy += 1
        wrappers = {"encode_blocks": encode_fused.encode_blocks,
                    "decode_blocks": decode_fused.decode_blocks}
        container.compress_blocks, container.decompress_blocks = compress_seen, decompress_seen
        try:
            for w in wrappers.values():
                w.launches = 0
            t0 = time.perf_counter()
            rec = zramsim.run(root, page_size=PAGE)           # device=None: the card
            wall = time.perf_counter() - t0
            launches = {k: w.launches for k, w in wrappers.items()}
        finally:
            container.compress_blocks, container.decompress_blocks = compress, decompress
    assert rec["orig_data_size"] == ZRAM_BYTES and all(n > 0 for n in launches.values()), \
        (rec, launches)

    # the first 64 pages of each corpus file: card container == plain versions'
    first = {}
    for data, cont in seen:                     # one file of each corpus member
        first.setdefault(data[: 64 * PAGE], (data, cont))
    n_plain = 0
    for data, cont in first.values():
        head = data[: 64 * PAGE]
        plain, _ = container.compress_blocks(head, PAGE, device="cpu")
        k = (len(head) + PAGE - 1) // PAGE
        table = np.frombuffer(cont, "<u4", count=k, offset=4)
        stored = (table & ~np.uint32(container.RAW_BIT)).astype(np.int64)
        start = 4 + 4 * int(np.frombuffer(cont, "<u4", count=1)[0])
        want = (np.array([k], "<u4").tobytes() + table.tobytes()
                + cont[start : start + int(stored.sum())])
        assert plain == want, f"container of a {len(data)}-byte file differs from plain"
        n_plain += k

    # every stored page, through the port's host decoder
    pages = comp_pages = 0
    for data, cont in seen:
        nr = int(np.frombuffer(cont, "<u4", count=1)[0])
        table = np.frombuffer(cont, "<u4", count=nr, offset=4)
        raw = (table == PAGE) | (table & container.RAW_BIT > 0)
        lens = (table & ~np.uint32(container.RAW_BIT)).astype(np.int64)
        offs = 4 + 4 * nr + np.concatenate([[0], np.cumsum(lens)])
        for i in range(nr):
            page = data[i * PAGE : (i + 1) * PAGE]
            body = cont[offs[i] : offs[i + 1]]
            got = body if raw[i] else native.decompress_noheader(body, len(page))
            assert got == page, f"page {i} of a {len(data)}-byte file"
        pages += nr
        comp_pages += int((~raw).sum())
    t0 = time.perf_counter()                    # zramsim hashes each file twice
    for data, _ in seen:
        hashlib.md5(data).hexdigest()
    md5_s = 2 * (time.perf_counter() - t0)
    c_s = sum(st.codec_seconds for st in stats["c"])
    d_s = sum(st.codec_seconds for st in stats["d"])
    hist = [sum(st.histogram[j] for st in stats["c"]) for j in range(3)]
    record = dict(rec, nr_pages=pages, page_size=PAGE, compressed_pages=comp_pages,
                  histogram=hist, codec_seconds_compress=c_s, codec_seconds_decompress=d_s,
                  compress_GBps=ZRAM_BYTES / c_s / 1e9, decompress_GBps=ZRAM_BYTES / d_s / 1e9,
                  host_seconds=rec["wall_seconds"] - rec["codec_seconds"], md5_seconds=md5_s,
                  wall_seconds_with_hooks=wall, launches=launches, card=card)
    print(f"[container] zramsim over {rec['nr_files']} files, {ZRAM_BYTES} B, {pages} pages of "
          f"{PAGE} B on the card: md5 readback of every file; {n_plain} pages equal to the "
          f"plain versions; all {pages} stored pages ({comp_pages} compressed) decode through "
          f"native.decompress_noheader to their input; launches {launches}", flush=True)
    print(json.dumps({"zram": record}), flush=True)
    return launches


def _container_fixture(np, dev) -> None:
    """Phase 8: the port's container equals the JAX fixture
    (``tests/data/torch_ref/container.npz``) byte for byte, stats and error
    codes included, on the card."""
    from csnappy_tpu_torch.errors import SnappyError
    from csnappy_tpu_torch.runtime import container

    z = np.load(DATA / "torch_ref" / "container.npz")
    for i, name in enumerate(str(s) for s in z["names"]):
        data = z["data"][z["data_offs"][i] : z["data_offs"][i + 1]].tobytes()
        want = z["cont"][z["cont_offs"][i] : z["cont_offs"][i + 1]].tobytes()
        page = int(z["page_size"][i])
        cont, sc = container.compress_blocks(data, page, device=dev)
        assert cont == want, name
        out, sd = container.decompress_blocks(cont, page, device=dev)
        assert out == data, name
        for st, key in ((sc, "stats_c"), (sd, "stats_d")):
            got = [st.nr_pages, st.bytes_in, st.bytes_out, *st.histogram]
            assert got == z[key][i].tolist(), (name, key, got)
    codes = []
    for i, name in enumerate(str(s) for s in z["bad_names"]):
        cont = z["bad_cont"][z["bad_offs"][i] : z["bad_offs"][i + 1]].tobytes()
        try:
            container.decompress_blocks(cont, int(z["bad_page_size"][i]), device=dev)
            code = 0
        except SnappyError as e:
            code = e.code
        assert code == int(z["bad_code"][i]), (name, code)
        codes.append(code)
    print(f"[container-fixture] {len(z['names'])} containers byte-identical to the JAX "
          f"fixture with equal stats; {len(codes)} malformed containers give its codes "
          f"{codes}", flush=True)


def _cli(urls: bytes, golden: bytes, fixture: bytes) -> None:
    """Phase 9: ``python -m csnappy_tpu_torch.cli`` in subprocesses on the
    card, in two waves of parallel processes."""
    import os
    import tempfile

    from csnappy_tpu_torch.runtime import container

    with tempfile.TemporaryDirectory(prefix="cli_") as tmp:
        t = pathlib.Path(tmp)
        src = DATA / "urls.10K"

        def run(wave):
            procs = {name: (subprocess.Popen(
                [sys.executable, "-m", "csnappy_tpu_torch.cli", *args], cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE), time.perf_counter())
                for name, args in wave.items()}
            for name, (p, t0) in procs.items():
                out, err = p.communicate(timeout=300)
                dt = time.perf_counter() - t0
                assert p.returncode == 0, (name, p.returncode, err.decode()[-2000:])
                print(f"[cli] {name}: exit 0 in {dt:.1f} s; {err.decode().strip()}", flush=True)

        run({"file -c": ["file", "-c", str(src), str(t / "u.snappy")],
             "file -d golden": ["file", "-d", str(DATA / "urls.10K.snappy"), str(t / "g.out")],
             "file -S c": ["file", "-S", "c"],
             "file -S d": ["file", "-S", "d"],
             "block -c": ["block", "-c", "-p", str(PAGE), str(src), str(t / "u.blk")]})
        run({"file -d": ["file", "-d", str(t / "u.snappy"), str(t / "u.out")],
             "block -d": ["block", "-d", "-p", str(PAGE), str(t / "u.blk"), str(t / "u.blkout")]})
        assert (t / "u.snappy").read_bytes() == fixture
        assert (t / "u.out").read_bytes() == urls and (t / "g.out").read_bytes() == urls
        assert (t / "u.blk").read_bytes() == container.compress_blocks(urls, PAGE, device="cuda")[0]
        assert (t / "u.blkout").read_bytes() == urls
    print("[cli] file -c equal to the JAX fixture stream, file -d and -d of the golden stream "
          "equal to urls.10K, selftests passed, block -c equal to the in-process container "
          "and block -d equal to urls.10K", flush=True)


def _or_not_measured(ms) -> str:
    """A device time from torch.profiler, or why there is none."""
    return "not measured (no device time in the trace)" if ms is None else f"{ms:.4f} ms"


def _movebench(torch, np, dev, card: str) -> list:
    """Phase 10: rows 12-13 (``lane_gather`` of ``csrc/primitives.cu`` and
    the scan of ``csrc/movebench.cu``) against their plain
    versions at n = 32768 and 2^24 with 0 differing elements, timed beside
    the library call and the bound; then ``movebench.main()`` with launch
    counts set to 0."""
    from csnappy_tpu_torch.tools import movebench as mb
    from csnappy_tpu_torch.tools.timing import device_profile, time_ms

    rows = {}
    for n in (32768, 1 << 24):
        tbl, idx = mb.inputs(n, dev)
        x = torch.from_numpy(np.random.default_rng(n).integers(0, 1 << 31, (n // 128, 128),
                                                                dtype=np.int32)).to(dev)
        tc, ic, xc = tbl.cpu(), idx.cpu(), x.cpu()
        got_g, got_s = mb.gather_flat(tbl, idx, 16, dev), mb.scan_max(x, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want_g = mb.gather_flat(tc, ic, 16, "cpu")
        plain_g = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want_s = mb.scan_max(xc, "cpu")
        plain_s = (time.perf_counter() - t0) * 1e3
        diff = {"gather_flat": int((got_g.cpu() != want_g).sum()),
                "scan_max": int((got_s.cpu() != want_s).sum())}
        err = {"gather_flat": int((got_g.cpu().long() - want_g.long()).abs().max()),
               "scan_max": int((got_s.cpu().long() - want_s.long()).abs().max())}
        assert not any(diff.values()) and not any(err.values()), (n, diff, err)
        ftbl, fidx, fx = tbl.reshape(-1), idx.reshape(-1), x.reshape(-1)
        for name, call, lib_ms, plain, nbytes in (
                ("gather_flat", lambda: mb.gather_flat(tbl, idx, 16, dev),
                 time_ms(lambda: ftbl[fidx]), plain_g, 12 * n),
                ("scan_max", lambda: mb.scan_max(x, dev),
                 time_ms(lambda: torch.cummax(fx, 0)), plain_s, 8 * n)):
            ms, device_ms = time_ms(call), device_profile(call)["device_ms"] or None
            bound_ms, bound_by = _bound(nbytes)
            print(f"[movebench] {name} n={n}: {ms:.4f} ms, kernel alone "
                  f"{_or_not_measured(device_ms)}, library {lib_ms:.4f} ms, plain "
                  f"{plain:.2f} ms (host CPU), bound {bound_ms:.5f} ms by {bound_by} "
                  f"({nbytes} B); 0 of {n} elements differ", flush=True)
            if n == 32768:
                rows[name] = {"name": name, "route": "cuda",
                              "source": "csnappy_tpu_torch/csrc/"
                                        + ("primitives.cu" if name == "gather_flat"
                                           else "movebench.cu"),
                              "entry": "lane_gather" if name == "gather_flat" else "scan",
                              "replaces": "csnappy_tpu/tools/movebench.py:"
                                          + ("62" if name == "gather_flat" else "92"),
                              "launches": 0, "max_abs_err": err[name], "ms": ms,
                              "device_ms": device_ms, "plain_ms": plain,
                              "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                              "bytes": nbytes}
            else:
                rows[name].update(ms_n16M=ms, device_ms_n16M=device_ms, library_ms_n16M=lib_ms,
                                  plain_ms_n16M=plain, bound_ms_n16M=bound_ms)
    mb.gather_flat.launches = mb.scan_max.launches = 0
    assert mb.main([]) == 0                                   # device=None: the card
    for name, w in (("gather_flat", mb.gather_flat), ("scan_max", mb.scan_max)):
        assert w.launches > 0, name
        rows[name]["launches"] = w.launches
    print(f"[movebench] main(): launches gather_flat {mb.gather_flat.launches}, scan_max "
          f"{mb.scan_max.launches}; card {card}", flush=True)
    return list(rows.values())


def _primitives(torch, np, dev, card: str) -> list:
    """Phase 11: rows 6-11 (``csrc/primitives.cu``) through the six wrappers
    of ``ops/primitives.py`` on the main path's batch with launch counts,
    against their plain versions and the JAX fixture, then timed."""
    from csnappy_tpu_torch.ops import primitives as prim
    from csnappy_tpu_torch.tools.movebench import primitive_inputs
    from csnappy_tpu_torch.tools.timing import device_profile, time_ms

    def tup(x):
        return x if isinstance(x, tuple) else (x,)

    host = {fn: [torch.from_numpy(a) for a in arrs] for fn, arrs in primitive_inputs(B).items()}
    on_card = {fn: [a.to(dev) for a in arrs] for fn, arrs in host.items()}
    torch.cuda.synchronize()
    for p in prim.PRIMITIVES.values():
        p.wrapper.launches = 0
    got = {fn: tup(p.wrapper(*on_card[fn])) for fn, p in prim.PRIMITIVES.items()}  # device=None
    torch.cuda.synchronize()
    launches = {fn: p.wrapper.launches for fn, p in prim.PRIMITIVES.items()}
    assert launches == {fn: 1 for fn in prim.PRIMITIVES}, launches
    print(f"[primitives] main path: the six wrappers on the card at B={B} x 32 KiB, "
          f"launches {launches}", flush=True)

    rows = []
    for fn, (wrapper, _, entry, replaces) in prim.PRIMITIVES.items():
        t0 = time.perf_counter()
        want = tup(wrapper(*host[fn], device="cpu"))
        plain_ms = (time.perf_counter() - t0) * 1e3
        diff = sum(int((g.cpu() != w).sum()) for g, w in zip(got[fn], want))
        err = max(int((g.cpu().long() - w.long()).abs().max()) for g, w in zip(got[fn], want))
        assert diff == 0 and err == 0, (fn, diff, err)
        nbytes = 4 * (sum(a.numel() for a in host[fn]) + sum(g.numel() for g in got[fn]))
        bound_ms, bound_by = _bound(nbytes)
        ms = time_ms(lambda: wrapper(*on_card[fn]))
        device_ms = device_profile(lambda: wrapper(*on_card[fn]))["device_ms"] or None
        library, lib_ms = None, None
        if fn == "local_scatter_or":
            m, t = on_card[fn]
            idx = t.clamp(0, 127).long()                        # set-up, not timed
            src = torch.where((t >= 0) & (t < 128), m, 0)
            library = "mask.scatter_reduce(-1, idx, src, 'amax', include_self=True)"
            lib_ms = time_ms(lambda: m.scatter_reduce(-1, idx, src, "amax", include_self=True))
            same = m.scatter_reduce(-1, idx, src, "amax", include_self=True)
            assert torch.equal(same, got[fn][0]), "the library call differs from the kernel"
        if fn in ("local_gather", "row_gather", "table_gather", "rowwise_gather"):
            src, ix = on_card[fn]
            width = src.shape[-1] if fn in ("local_gather", "rowwise_gather") else src.shape[0]
            ix64 = ix.clamp(0, width - 1).long()
            library, call = {
                "local_gather": ("torch.gather(values, -1, idx)",
                                 lambda: torch.gather(src, -1, ix64)),
                "row_gather": ("torch.index_select(table2d, 0, rows)",
                               lambda: torch.index_select(src, 0, ix64)),
                "table_gather": ("torch.take(table, idx)", lambda: torch.take(src, ix64)),
                "rowwise_gather": ("torch.gather(tables, 1, idx)",
                                   lambda: torch.gather(src, 1, ix64)),
            }[fn]
            lib_ms = time_ms(call)
        shapes = [tuple(a.shape) for a in host[fn]]
        print(f"[primitives] {fn} ({entry}) {shapes}: {ms:.4f} ms, kernel alone "
              f"{_or_not_measured(device_ms)}, plain {plain_ms:.2f} ms (host "
              f"CPU), bound {bound_ms:.5f} ms by {bound_by} ({nbytes} B), library "
              + (f"{library} {lib_ms:.4f} ms (in-range int64 indices)" if library else "none")
              + f"; 0 of {sum(g.numel() for g in got[fn])} elements differ", flush=True)
        rows.append({"name": fn, "route": "cuda", "source": "csnappy_tpu_torch/csrc/primitives.cu",
                     "replaces": replaces, "entry": entry, "launches": launches[fn],
                     "max_abs_err": err, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms, "library": library,
                     "bytes": nbytes})

    z = np.load(DATA / "torch_ref" / "primitives.npz")
    for case, fn, limbs in zip(z["cases"], z["fns"], z["limbs"]):
        case, fn, limbs = str(case), str(fn), int(limbs)
        args = [torch.from_numpy(z[f"{case}__{a}"]).to(dev) for a in prim.PRIMITIVES[fn].args]
        outs = tup(prim.PRIMITIVES[fn].wrapper(*args, **({"limbs": limbs} if limbs else {})))
        torch.cuda.synchronize()
        for k, o in enumerate(outs):
            assert np.array_equal(o.cpu().numpy(), z[f"{case}__out{k}"]), (case, k)
    print(f"[primitives] {len(z['cases'])} fixture cases equal to the JAX Pallas kernels on the "
          f"card (values outside the limbs' contract included); card {card}", flush=True)
    return rows


def _probes(torch, np, dev, card: str) -> tuple[list, dict]:
    """Phase 12: rows 14a-14i (``csrc/probe.cu``, ``csrc/probe3.cu``, ``csrc/probe4.cu``) through
    ``tools/probe.py`` with launch counts: every probe with a kernel measured on the card and held
    against its plain version and the JAX probes' answers.  Returns one ``kernels`` row per
    ``pl.pallas_call`` site and each probe's measurement."""
    from csnappy_tpu_torch.tools import probe

    # one measurement a kernel: probes that share an entry (mosaic_probe6's
    # four gathers, one function) are measured once, under the first name
    same = {}
    for name in probe.TIMED:
        same.setdefault((probe.PROBES[name].lib, probe.PROBES[name].entry), []).append(name)
    also = {names[0]: names[1:] for names in same.values()}
    for name in probe.PROBES:
        probe.probe.launches[name] = 0
    names = tuple(also) + ("mosaic_probe5.smem_cap",)
    recs = {name: probe.measure(name) for name in names}               # device=None: the card
    torch.cuda.synchronize()
    launches = {name: probe.probe.launches[name] for name in names}
    assert all(n > 0 for n in launches.values()), launches
    bad = [name for name, r in recs.items() if not r["result_equals_plain"]]
    assert not bad, bad
    clocks = probe.clocks()
    for name, r in recs.items():
        if r["ns_per_iter"] is None:
            continue
        print(f"[probes] {name}: {r['ns_per_iter']:.2f} ns, {r['cycles_per_iter']:.2f} SM cycles "
              f"an iteration of {r['steps_per_iter']} step(s) (K {r['k_lo']} -> {r['k_hi']}, "
              f"{r['space']} memory); {r['ms']:.4f} ms at K = {r['k_hi']}, plain "
              f"{r['plain_ms']:.1f} ms (host CPU); {launches[name]} launches"
              + (f"; the same kernel as {', '.join(also[name])}" if also.get(name) else ""),
              flush=True)
    cap = recs["mosaic_probe5.smem_cap"]
    print(f"[probes] shared-memory capacity of a block: {cap['capacity_bytes']} bytes; (rows, 128) "
          f"int32 scratch runs at rows {cap['rows_ok']}", flush=True)

    z = np.load(DATA / "torch_ref" / "probes.npz")
    ncase = 0
    for name in probe.TIMED:
        tbl = probe.second_input(name)
        htab = None if tbl is None else torch.from_numpy(tbl)
        tab = None if htab is None else htab.to(dev)
        for key in (k for k in z.files if k.startswith(name + "__")):
            # <name>__k<K> on the probe's own input, <name>__<case>_k<K> on case_<case>
            case, k = key.split("__")[1].rsplit("k", 1)
            host = torch.from_numpy(z["case_" + case[:-1]] if case else probe.inputs(name))
            got = probe.probe(name, int(k), host.to(dev), tab).cpu()
            want = probe.probe(name, int(k), host, htab, device="cpu")
            assert np.array_equal(got.numpy(), z[key]) and torch.equal(got, want), key
            ncase += 1
    rand = torch.from_numpy(z["case_p4rand"])
    wrapped = []
    for name in (n for n in probe.TIMED if n.startswith("mosaic_probe4.gather_r")):
        got = probe.probe(name, probe.WRAP_K, rand.to(dev)).cpu()
        want = probe.probe(name, probe.WRAP_K, rand, device="cpu")
        assert torch.equal(got, want), name
        wrapped += [int(want[0, 0])] if name.endswith("_l2") else []
    assert all(v < 0 for v in wrapped), wrapped
    print(f"[probes] {ncase} fixture cases equal to the JAX probes and to the plain versions on "
          f"the card; the 12 resolve-phase gathers at K = {probe.WRAP_K} on case_p4rand equal to "
          f"the plain versions past the int32 wrap of their sum (16-bit answers {wrapped}); card "
          f"{card}; SM clock {clocks['clocks.sm']} (max {clocks['clocks.max.sm']})", flush=True)

    rows = []
    for call, site in probe.SITES.items():
        names = [n for n in recs if probe.PROBES[n].call == call]
        sub = [{k: recs[n][k] for k in ("probe", "ns_per_iter", "cycles_per_iter", "ms", "k_lo",
                                        "k_hi", "steps_per_iter", "space", "plain_ms", "bound_ms")}
               | {"launches": launches[n], "same_kernel_as": also.get(n, [])} for n in names]
        sub += [{"probe": n, "fails_to_trace_in_jax": p.fails, "kernel": None}
                for n, p in probe.PROBES.items() if p.call == call and p.fails]
        top = max(names, key=lambda n: recs[n]["bound_ms"])
        row = {"name": f"probe:{site}", "route": "cuda",
               "source": f"csnappy_tpu_torch/csrc/{probe.PROBES[top].lib}.cu", "replaces": call,
               "launches": sum(launches[n] for n in names),
               "max_abs_err": max(recs[n]["max_abs_err"] for n in names),
               "ms": sum(recs[n]["ms"] for n in names),
               "plain_ms": sum(recs[n]["plain_ms"] for n in names),
               "bound_ms": sum(recs[n]["bound_ms"] for n in names),
               "bound_by": recs[top]["bound_by"], "library_ms": None, "probes": sub,
               "clocks_sm": clocks["clocks.sm"]}
        if site.endswith("smem_cap"):
            row.update(capacity_bytes=cap["capacity_bytes"], rows_ok=cap["rows_ok"])
        rows.append(row)
    return rows, recs


def _kernel_lib(torch, np, dev, card: str) -> list:
    """Phase 13: rows 15a-15b (``csrc/kernel_lib.cu``) through the helpers of
    ``ops/kernel_lib.py`` with launch counts: every fixture case on the card,
    held against the JAX helpers' answers and the plain versions; a call of
    each helper and of its PyTorch counterpart timed in ``KL_ROUNDS``
    interleaved rounds (the median of 20 calls a round), the median round
    kept with its spread.  Returns the two ``kernels`` rows."""
    from csnappy_tpu_torch.ops import kernel_lib as kl
    from csnappy_tpu_torch.tools.timing import (HBM_BYTES_PER_S, OPS_PER_S, device_profile,
                                                time_ms)

    cases = kl.read_cases(DATA / "torch_ref" / "kernel_lib.npz")
    on_card = {c[0]: {k: torch.from_numpy(v).to(dev) for k, v in c[2].items()} for c in cases}
    torch.cuda.synchronize()
    for name in kl.launches:
        kl.launches[name] = 0
    got, case_launches = {}, {}
    for case, helper, _, params, _ in cases:
        before = kl.launches[helper]
        got[case] = kl.call(helper, on_card[case], params)          # device=None: the card
        case_launches[case] = kl.launches[helper] - before
    torch.cuda.synchronize()
    launches = dict(kl.launches)
    assert launches == {h: sum(c[1] == h for c in cases) for h in kl.HELPERS}, launches
    err = dict.fromkeys(kl.HELPERS, 0)
    for case, helper, arrays, params, outs in cases:
        want = kl.call(helper, {k: torch.from_numpy(v) for k, v in arrays.items()}, params,
                       device="cpu")
        assert len(got[case]) == len(outs) == len(want), case
        for g, o, w in zip(got[case], outs, want):
            g = g.cpu()
            assert np.array_equal(g.numpy(), o) and torch.equal(g, w), case
            err[helper] = max(err[helper], int((g.long() - w.long()).abs().max()))
    print(f"[kernel_lib] main path: the {len(kl.HELPERS)} helpers on the card on the "
          f"{len(cases)} cases of kernel_lib.npz (the 35 of tests/test_kernel_lib.py, answers "
          f"outside the contracts, the helpers no JAX test runs), equal to the JAX helpers and "
          f"the plain versions; launches {launches}", flush=True)

    def library(helper, a, params):
        """One PyTorch call computing the helper inside its contract, or None."""
        x = next(iter(a.values()))
        d, k = params.get("d", 0), params.get("k", 0) % 128
        flat = x.reshape(-1)
        pad = torch.nn.functional.pad
        calls = {
            "stream_shift_down": ("F.pad(x.flat[:n - d], (d, 0), value=fill)",
                                  lambda: pad(flat[: flat.numel() - d], (d, 0),
                                              value=params.get("fill", 0))),
            "stream_shift_up": ("F.pad(x.flat[d:], (0, d), value=fill)",
                                lambda: pad(flat[d:], (0, d), value=params.get("fill", 0))),
            "stream_shift_up_mm": ("F.pad(x.flat[d:], (0, d))", lambda: pad(flat[d:], (0, d))),
            "stream_shift_down_mm": ("F.pad(x.flat[:n - d], (d, 0))",
                                     lambda: pad(flat[: flat.numel() - d], (d, 0))),
            "lane_shift_down": ("F.pad(x[:, :128 - k], (k, 0))",
                                lambda: pad(x[:, : 128 - k], (k, 0))),
            "lane_shift_up": ("F.pad(x[:, k:], (0, k))", lambda: pad(x[:, k:], (0, k))),
            "row_shift_down": ("F.pad(x[:R - k], (0, 0, k, 0), value=fill)",
                               lambda: pad(x[: max(x.shape[0] - k, 0)],
                                           (0, 0, min(k, x.shape[0]), 0),
                                           value=params.get("fill", 0))),
            "row_shift_up": ("F.pad(x[k:], (0, 0, 0, k), value=fill)",
                             lambda: pad(x[k:], (0, 0, 0, min(k, x.shape[0])),
                                         value=params.get("fill", 0))),
            "scan2d": ("torch.cummax / torch.cumsum of x.flat", lambda: torch.cummax(flat, 0)
                       if params["op"] == "max" else torch.cumsum(flat, 0, dtype=torch.int32)),
            "scan2d_mm": ("torch.cummax / torch.cumsum of x.flat", lambda: torch.cummax(flat, 0)
                          if params["op"] == "max" else torch.cumsum(flat, 0, dtype=torch.int32)),
            "scan2d_tril": ("torch.cumsum(x.flat)",
                            lambda: torch.cumsum(flat, 0, dtype=torch.int32)),
            "flip2d": ("torch.flip(x.flat, (0,))", lambda: torch.flip(flat, (0,))),
        }
        if helper in ("gather_flat", "local_gather_rows", "lane_gather"):
            tbl, ix = a.values()
            ix64 = ix.long().clamp(0, (tbl.numel() if helper == "gather_flat" else 128) - 1)
            calls[helper] = (("torch.take(table, idx)", lambda: torch.take(tbl, ix64))
                             if helper == "gather_flat" else
                             ("torch.gather(x, 1, idx)", lambda: torch.gather(tbl, 1, ix64)))
        if helper == "gather_rows_multi":
            *tbls, ix = a.values()
            stacked = torch.stack([t.reshape(-1) for t in tbls])     # set-up, not timed
            rows = ix[params["r0"] : params["r0"] + params["nrows"]].reshape(-1)
            ix64 = rows.long().clamp(0, stacked.shape[1] - 1)
            calls[helper] = ("torch.index_select(stacked tables, 1, idx)",
                             lambda: torch.index_select(stacked, 1, ix64))
        if helper == "scatter_rows_multi":
            calls[helper] = _index_add(torch, kl, a, params)
        if helper == "scatter_sum_tile":
            pos, val, mask = a.values()
            calls[helper] = _tile_index_add(torch, pos, val, 128 * params["out_rows"], mask != 0)
        return calls.get(helper, (None, None))

    first = {helper: next(c for c in cases if c[1] == helper) for helper in kl.HELPERS}
    libs = {helper: library(helper, on_card[c[0]], c[3]) for helper, c in first.items()}
    # scatter_rows_multi's yardstick is the stacked tables' index_add_ over rows
    # r0..r0+nrows-1 (_index_add); the one table's index_add_ over the whole
    # position tile, which earlier runs divided by, is timed beside it
    srm_case, _, _, srm_params, _ = first["scatter_rows_multi"]
    tile_name, tile_add = _tile_index_add(torch, *list(on_card[srm_case].values())[:2],
                                          128 * srm_params["out_rows"])
    tile_ms = []
    call_ms = {helper: [] for helper in kl.HELPERS}
    lib_ms = {helper: [] for helper in kl.HELPERS}
    plain_ms = {helper: [] for helper in kl.HELPERS}
    for _ in range(KL_ROUNDS):          # interleaved: a slow spell hits every helper
        for helper, (case, _, arrays, params, _) in first.items():
            call_ms[helper].append(time_ms(lambda: kl.call(helper, on_card[case], params)))
            if libs[helper][1] is not None:
                lib_ms[helper].append(time_ms(libs[helper][1]))
            if helper == "scatter_rows_multi":
                tile_ms.append(time_ms(tile_add))
            host = {k: torch.from_numpy(v) for k, v in arrays.items()}
            t0 = time.perf_counter()
            kl.call(helper, host, params, device="cpu")
            plain_ms[helper].append((time.perf_counter() - t0) * 1e3)

    subs = {"15a": [], "15b": []}
    for helper, h in kl.HELPERS.items():
        case, _, arrays, params, _ = first[helper]
        a = on_card[case]
        device_ms = device_profile(lambda: kl.call(helper, a, params))["device_ms"] or None
        nbytes, nops = kl.traffic(helper, arrays, params)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, nops / OPS_PER_S * 1e3
        ms, lib_name = statistics.median(call_ms[helper]), libs[helper][0]
        lms = statistics.median(lib_ms[helper]) if lib_ms[helper] else None
        shapes = [list(v.shape) for v in arrays.values()]
        subs[h.row].append({"helper": helper, "kind": h.kind, "jax": h.jax, "test": h.test,
                            "case": case, "shapes": shapes,
                            "launches": launches[helper], "max_abs_err": err[helper], "ms": ms,
                            "ms_rounds": call_ms[helper], "device_ms": device_ms,
                            "plain_ms": statistics.median(plain_ms[helper]),
                            "bound_ms": max(bytes_ms, ops_ms), "bound_bytes": nbytes,
                            "bound_ops": nops,
                            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                            "library": lib_name, "library_ms": lms,
                            "library_ms_rounds": lib_ms[helper] or None})
        if helper == "scatter_rows_multi":
            subs[h.row][-1].update(library_one_table=tile_name,
                                   library_one_table_ms=statistics.median(tile_ms))
        print(f"[kernel_lib] {helper} ({h.kind}) on {case} {shapes}: {ms:.4f} ms a call (median "
              f"of {KL_ROUNDS} rounds, {min(call_ms[helper]):.4f}-{max(call_ms[helper]):.4f}), "
              f"kernel alone {_or_not_measured(device_ms)}, plain "
              f"{statistics.median(plain_ms[helper]):.2f} ms (host CPU), bound "
              f"{max(bytes_ms, ops_ms):.7f} ms ({nbytes} B, {nops} operations), library "
              + (f"{lib_name} {lms:.4f} ms ({min(lib_ms[helper]):.4f}-"
                 f"{max(lib_ms[helper]):.4f})" if lms is not None else "none")
              + f"; {launches[helper]} launches", flush=True)
    print(f"[kernel_lib] scatter_rows_multi on {srm_case}: {tile_name} "
          f"{statistics.median(tile_ms):.4f} ms ({min(tile_ms):.4f}-{max(tile_ms):.4f})",
          flush=True)
    by_case = {c[0]: c for c in cases}
    shapes = _scatter_shapes(torch, kl, {c: by_case[c] for c in MAIN_SCATTERS}, on_card,
                             case_launches, card)
    split = {helper: _host_split(torch, kl, helper, on_card[case], by_case[case][3])
             for helper, case in (("scatter_rows_multi", MAIN_SCATTERS[0]),
                                  ("scatter_sum_tile", first["scatter_sum_tile"][0]))}
    rows = []
    for row, name, replaces in (
            ("15a", "kernel_lib:test_kernel_lib._run", "tests/test_kernel_lib.py:16"),
            ("15b", "kernel_lib:test_kernel_lib.gather_rows_multi",
             "tests/test_kernel_lib.py:137")):
        sub = subs[row]
        # one PyTorch call for the row: only where the row is one helper (15b)
        library_ms = sub[0]["library_ms"] if len(sub) == 1 else None
        rows.append({"name": name, "route": "cuda",
                     "source": "csnappy_tpu_torch/csrc/kernel_lib.cu", "replaces": replaces,
                     "launches": sum(r["launches"] for r in sub),
                     "max_abs_err": max(r["max_abs_err"] for r in sub),
                     "ms": sum(r["ms"] for r in sub), "plain_ms": sum(r["plain_ms"] for r in sub),
                     "bound_ms": sum(r["bound_ms"] for r in sub),
                     "bound_by": max(sub, key=lambda r: r["bound_ms"])["bound_by"],
                     "library_ms": library_ms, "helpers": sub})
    rows[0].update(scatter_main_shapes=shapes, scatter_host_split=split)
    print(f"[kernel_lib] card {card}", flush=True)
    return rows


# scatter_rows_multi at the shapes of csnappy_tpu/ops/decode_fused.py:470,
# decode_stream.py:315 and encode_fused.py:375 (fixture cases of kernel_lib.npz)
MAIN_SCATTERS = ("srm_dec_co256", "srm_stream_co256_t3", "srm_enc_ocr304_t3")


def _index_add(torch, kl, a, params):
    """One ``index_add_`` computing ``scatter_rows_multi`` inside its
    contract: the stacked tables' in-range positions and masked values,
    prepared outside the timed call."""
    pos, *vals = a.values()
    sl = slice(params["r0"], params["r0"] + params["nrows"])
    p = pos[sl].reshape(-1)
    n_out = 128 * params["out_rows"]
    keep = (p >= 0) & (p < n_out)
    masks = [kl.bits_mask(b, 7) for b in params["bits"]]
    V = torch.stack([v[sl].reshape(-1)[keep] & m if m != kl.FULL else v[sl].reshape(-1)[keep]
                     for v, m in zip(vals, masks)])
    idx = p[keep].long()
    H = torch.zeros((len(vals), n_out), dtype=torch.int32, device=pos.device)
    return ("H.index_add_(1, pos, V) (stacked tables, in-range positions, masked values)",
            lambda: H.index_add_(1, idx, V))


def _tile_index_add(torch, pos, val, n_out: int, mask=None):
    """One ``index_add_`` of one value tile over the whole position tile:
    the in-range positions where ``mask`` is set, prepared outside the
    timed call."""
    keep = (pos >= 0) & (pos < n_out)
    if mask is not None:
        keep &= mask
    p_ok, v_ok = pos[keep].long(), val[keep]
    h = torch.zeros(n_out, dtype=torch.int32, device=pos.device)
    return ("H.index_add_(0, pos, val) (one table, the whole tile, in-range positions)",
            lambda: h.index_add_(0, p_ok, v_ok))


def _scatter_shapes(torch, kl, cases, on_card, case_launches: dict, card: str) -> list:
    """``scatter_rows_multi`` on each case, and one ``index_add_`` of the same
    function, timed in ``KL_ROUNDS`` interleaved rounds; the kernel alone,
    the bound (``kernel_lib.traffic``) and each case's launches in the
    main-path run (``case_launches``, one a case)."""
    from csnappy_tpu_torch.ops import _build
    from csnappy_tpu_torch.tools.timing import (HBM_BYTES_PER_S, OPS_PER_S, device_profile,
                                                time_ms)

    log = _build.log_path("kernel_lib").read_text().splitlines()
    at = next(i for i, line in enumerate(log) if "scatter_harness" in line)
    used = next(line.split(":", 1)[1].strip() for line in log[at:] if "Used" in line)
    print(f"[kernel_lib] scatter_harness (ptxas -v): {used}; dynamic shared memory a block "
          f"{kl.SCATTER_SLICE} positions x limbs x 4 B (scatter_plan), 1024 threads", flush=True)
    libs = {case: _index_add(torch, kl, on_card[case], c[3]) for case, c in cases.items()}
    call_ms = {case: [] for case in cases}
    lib_ms = {case: [] for case in cases}
    for _ in range(KL_ROUNDS):
        for case, (_, helper, _, params, _) in cases.items():
            call_ms[case].append(time_ms(lambda: kl.call(helper, on_card[case], params)))
            lib_ms[case].append(time_ms(libs[case][1]))
    out = []
    for case, (_, helper, arrays, params, _) in cases.items():
        assert case_launches[case] == 1, (case, case_launches[case])
        device_ms = device_profile(lambda: kl.call(helper, on_card[case], params))["device_ms"]
        nbytes, nops = kl.traffic(helper, arrays, params)
        bound = max(nbytes / HBM_BYTES_PER_S, nops / OPS_PER_S) * 1e3
        ms, lms = statistics.median(call_ms[case]), statistics.median(lib_ms[case])
        tables = len(params["bits"])
        plan = kl.scatter_plan(tables, 128 * params["out_rows"], 0)
        out.append({"case": case, "tables": tables, "out_rows": params["out_rows"],
                    "grid": plan.grid, "smem": plan.smem,
                    "nrows": params["nrows"], "ms": ms, "ms_rounds": call_ms[case],
                    "device_ms": device_ms or None, "bound_ms": bound, "bound_bytes": nbytes,
                    "bound_ops": nops, "library": libs[case][0], "library_ms": lms,
                    "library_ms_rounds": lib_ms[case], "launches": case_launches[case]})
        print(f"[kernel_lib] scatter_rows_multi on {case} ({tables} tables x {params['out_rows']} "
              f"rows, rows {params['r0']}..{params['r0'] + params['nrows'] - 1} of a "
              f"{arrays['pos'].shape[0]}-row tile): {ms:.4f} ms a call (median of {KL_ROUNDS} "
              f"rounds, {min(call_ms[case]):.4f}-{max(call_ms[case]):.4f}), kernel alone "
              f"{_or_not_measured(device_ms or None)}, bound {bound:.7f} ms ({nbytes} B), "
              f"{libs[case][0]} {lms:.4f} ms ({min(lib_ms[case]):.4f}-{max(lib_ms[case]):.4f}), "
              f"{ms / lms:.2f}x; {case_launches[case]} launch(es) in the main-path run, "
              f"{plan.grid[0]} x {plan.grid[1]} blocks, "
              f"{plan.smem} B of shared memory each; card {card}", flush=True)
    return out


def _host_split(torch, kl, helper: str, a: dict, params: dict, n: int = 1000) -> dict:
    """Microseconds of each host step of one call of a scatter helper on the
    card on the arrays ``a``, as the wrapper takes it: each step alone ``n``
    times on ``time.perf_counter_ns`` after a synchronise, then the whole
    call.  ``scatter_sum_tile`` gets the JAX signature's bool mask."""
    from csnappy_tpu_torch.ops.primitives import _stream, as_int32

    def us(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter_ns() - t0) / n / 1e3

    dev = next(iter(a.values())).device
    steps = {}
    if helper == "scatter_rows_multi":
        pos, *vals = a.values()
        bits, r0, nrows, out_rows = params["bits"], params["r0"], params["nrows"], params["out_rows"]
        ops, limbs, off = (pos, *vals), 0, 4 * 128 * r0
        masks = kl._masks7(tuple(bits))
        mask_ptr, mask_bytes, npos = None, 0, nrows * 128
        steps["operand checks"] = lambda: (kl._operands(None, *ops), kl._masks7(tuple(bits)))
        steps["conversions"] = lambda: [kl._tile(x, dev, "x") for x in ops]
        steps["row offset"] = lambda: [x.data_ptr() + off for x in ops]
        call = lambda: kl.scatter_rows_multi(pos, list(zip(vals, bits)), r0, out_rows, nrows)
    else:
        pos, val = a["pos_row"], a["val_row"]
        mask = a["mask_row"] != 0
        vals, out_rows, off = [val], params["out_rows"], 0
        limbs, masks = kl.bits_mask(params["bits"]).bit_length() // 8, (kl.FULL,)
        mask_ptr, mask_bytes, npos = mask.data_ptr(), mask.element_size(), pos.numel()
        steps["operand checks"] = lambda: kl._operands(None, pos, val, mask)
        steps["conversions"] = lambda: (as_int32(pos, dev, "x"), as_int32(val, dev, "x"),
                                        kl._mask(mask, dev))
        call = lambda: kl.scatter_sum_tile(pos, val, mask, out_rows, params["bits"])
    ntab, n_out = len(vals), out_rows * 128
    shape = (n_out // 128, 128) if ntab == 1 else (ntab, n_out // 128, 128)
    out = torch.empty(shape, dtype=torch.int32, device=dev)

    def allocate():
        o = pos.new_empty(shape)
        return [o] if o.ndim == 2 else list(o.unbind(0))

    steps["allocation"] = allocate
    steps["ctypes arguments"] = lambda: (kl._PTRS(*(v.data_ptr() + off for v in vals)),
                                         kl._uints(masks), kl.scatter_plan(ntab, n_out, limbs).slice)
    steps["device and stream"] = lambda: (dev.index == torch.cuda.current_device(),
                                          _stream(dev.index))
    launch, check = kl._entry("scatter")
    args = (pos.data_ptr() + off, mask_ptr, mask_bytes, npos,
            kl._PTRS(*(v.data_ptr() + off for v in vals)), kl._uints(masks), ntab, limbs, n_out,
            kl.scatter_plan(ntab, n_out, limbs).slice, out.data_ptr(), _stream(dev.index))
    steps["launch entry"] = lambda: check(launch(*args))

    split = {step: us(fn) for step, fn in steps.items()}
    whole = us(call)
    total = sum(split.values())
    print(f"[kernel_lib] host split of one {helper} call ({ntab} table(s) x {out_rows} rows), "
          f"us (time.perf_counter_ns, {n} runs a step): "
          + "; ".join(f"{k} {v:.2f}" for k, v in split.items())
          + f"; the steps {total:.2f}, the whole call {whole:.2f} (the rest: Python between "
          f"the steps)", flush=True)
    return {"steps_us": split, "steps_total_us": total, "call_us": whole}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "csnappy_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: csnappy_tpu_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from csnappy_tpu_torch import api
    from csnappy_tpu_torch.models import pymodel, wire
    from csnappy_tpu_torch.ops import _build, decode_fused, encode_fused
    from csnappy_tpu_torch.runtime import native
    from csnappy_tpu_torch.tools.timing import time_ms

    dev = torch.device("cuda")
    card = _smi("name,power.limit,clocks.max.sm")
    name_, power_, clock_ = (s.strip() for s in card.split(","))
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {card}", flush=True)

    # ------------------------------------------------------------ 1. build
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    for name in _build.CUDA_NAMES:
        for line in _build.log_path(name).read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    urls = (DATA / "urls.10K").read_bytes()
    golden = (DATA / "urls.10K.snappy").read_bytes()
    fixture = (DATA / "torch_ref" / "urls.10K.jax.snappy").read_bytes()
    unaligned = (DATA / "unaligned_uint64_test.bin").read_bytes()
    baddata3 = (DATA / "baddata3.snappy").read_bytes()

    # ----------------------------------------------------------- 2. decode
    distinct = [urls[i * BS : (i + 1) * BS] for i in range(21)]
    frag_of = [pymodel.compress_fragment(b) for b in distinct]
    blocks = [distinct[i % 21] for i in range(B)]
    frags = [frag_of[i % 21] for i in range(B)]
    comp, lens = _pack(torch, frags)
    got = decode_fused.decode_blocks(comp.to(dev), lens, BS, device=dev)
    torch.cuda.synchronize()
    err_dec = _same("decode_blocks B=64", got, decode_fused.decode_blocks(
        comp, lens, BS, device="cpu"))
    for i, b in enumerate(blocks):
        assert int(got[1][i]) == len(b) and got[0][i, : len(b)].cpu().numpy().tobytes() == b
    tags = [_tags(f)[0] for f in frags]
    print(f"[decode] B=64 x 32 KiB equal to plain and to the source; tags/block max "
          f"{max(tags)} mean {sum(tags) / B:.0f}; compressed {int(lens.sum())} B", flush=True)

    rng = np.random.default_rng(7)
    prio = bytearray()                       # bad offset before the overrun point
    wire.emit_literal(prio, b"ab")
    prio += bytes([wire.TAG_COPY_1, 50])
    wire.emit_literal(prio, b"c" * 60)
    bad = [baddata3[wire.varint_decode(baddata3)[1]:], b"\xc4foooooo", bytes(prio),
           pymodel.compress_fragment(b"y" * 5000)[:-1]]   # overrun before the truncated end
    for _ in range(12):
        m = bytearray(frag_of[int(rng.integers(0, 21))])
        for _k in range(int(rng.integers(1, 6))):
            m[int(rng.integers(0, len(m)))] = int(rng.integers(0, 256))
        bad.append(bytes(m))
    mcomp, mlens = _pack(torch, bad)
    statuses = {}
    for cap in (0, 4, 4096, BS):
        g = decode_fused.decode_blocks(mcomp.to(dev), mlens, cap, device=dev)
        torch.cuda.synchronize()
        _same(f"decode_blocks malformed cap={cap}", g,
              decode_fused.decode_blocks(mcomp, mlens, cap, device="cpu"))
        statuses[cap] = g[2].cpu().tolist()
    assert statuses[4][2] == -5 and statuses[4096][3] == -3 and statuses[BS][1] == -5, statuses
    print(f"[decode] {len(bad)} malformed/priority vectors equal to plain at caps 0, 4, 4096, "
          f"32768; statuses at 32768: {statuses[BS]}", flush=True)

    body = golden[wire.varint_decode(golden)[1]:]
    rc, offs, produced = native.scan_segments(body, len(urls), BS)
    assert rc == 0 and produced == len(urls), (rc, produced)
    slens = np.diff(np.append(offs, len(body)))
    sdl = np.minimum(BS, len(urls) - np.arange(len(offs)) * BS)
    body_dev = torch.frombuffer(bytearray(body), dtype=torch.uint8).to(dev)
    gseg = decode_fused.decode_segments(body_dev, offs, slens, sdl, device=dev)
    torch.cuda.synchronize()
    err_seg = _same("decode_segments", gseg, decode_fused.decode_segments(
        body, offs, slens, sdl, device="cpu"))
    assert gseg[0].reshape(-1)[: len(urls)].cpu().numpy().tobytes() == urls
    seg_tags = [_tags(body[o : o + n])[0] for o, n in zip(offs, slens)]
    print(f"[decode] decode_segments over urls.10K.snappy ({len(offs)} segments) equal to "
          f"plain and to urls.10K; tags/segment max {max(seg_tags)}", flush=True)

    # ----------------------------------------------------------- 3. encode
    data = torch.zeros((B, BS), dtype=torch.uint8)
    for i, b in enumerate(blocks):
        data[i, : len(b)] = torch.frombuffer(bytearray(b), dtype=torch.uint8)
    blens = torch.full((B,), BS, dtype=torch.int32)
    ec, en = encode_fused.encode_blocks(data.to(dev), blens, device=dev)
    torch.cuda.synchronize()
    pc, pn = encode_fused.encode_blocks(data, blens, device="cpu")
    assert (en.cpu() == pn).all(), "encode lengths differ"
    err_enc = int((ec.cpu().int() - pc.int()).abs().max())
    assert err_enc == 0, f"encode bytes differ (max abs err {err_enc})"
    commits = [_tags(ec[i, : int(en[i])].cpu().numpy().tobytes())[1] for i in range(B)]
    stream = encode_fused.compress_np(urls, device=dev)
    assert stream == fixture, f"compress_np: {len(stream)} B, not the fixture's {len(fixture)} B"
    print(f"[encode] B=64 x 32 KiB equal to plain ({int(en.sum())} B); compress_np(urls.10K) "
          f"= {len(stream)} B, byte-identical to the JAX fixture; commits/block max "
          f"{max(commits)}", flush=True)

    # -------------------------------------------------------- 4. main path
    wrappers = {"decode_blocks": decode_fused.decode_blocks,
                "decode_segments": decode_fused.decode_segments,
                "encode_blocks": encode_fused.encode_blocks}
    for w in wrappers.values():
        w.launches = 0
    mc, ml = encode_fused.encode_blocks(data.numpy(), blens.numpy())
    assert torch.equal(mc.cpu(), pc) and torch.equal(ml.cpu(), pn)
    mo, mp, ms_ = decode_fused.decode_blocks(comp.numpy(), lens.numpy(), BS)
    assert (ms_.cpu() == 0).all() and torch.equal(mo.cpu(), got[0].cpu())
    assert api.compress(urls) == fixture
    assert api.decompress(golden) == urls
    assert api.decompress(fixture) == urls
    assert api.decompress_noheader(api.compress_fragment(urls[:BS]), BS) == urls[:BS]
    assert api.decompress(api.compress(unaligned)) == unaligned
    launches = {k: w.launches for k, w in wrappers.items()}
    assert all(n > 0 for n in launches.values()), launches
    print(f"[main] B=64 batch and api compress/decompress end to end on the card; "
          f"launches {launches}", flush=True)

    # ------------------------------------------------------------ 5. times
    flat = comp.to(dev).reshape(-1)
    offs_b = torch.arange(B, device=dev, dtype=torch.int64) * comp.shape[1]
    lens_b = lens.to(dev)
    dl_b = torch.full((B,), BS, dtype=torch.int32, device=dev)
    dec_ms = time_ms(lambda: decode_fused._launch(
        decode_fused.decode_blocks, flat, offs_b, lens_b, dl_b, BS))
    dec_plain = _host_ms(lambda: decode_fused.decode_blocks(comp, lens, BS, device="cpu"))
    offs_s = torch.as_tensor(offs, dtype=torch.int64, device=dev)
    lens_s = torch.as_tensor(slens, dtype=torch.int32, device=dev)
    dl_s = torch.as_tensor(sdl, dtype=torch.int32, device=dev)
    seg_ms = time_ms(lambda: decode_fused._launch(
        decode_fused.decode_segments, body_dev, offs_s, lens_s, dl_s, BS))
    seg_plain = _host_ms(lambda: decode_fused.decode_segments(body, offs, slens, sdl,
                                                              device="cpu"))
    data_dev, blens_dev = data.to(dev), blens.to(dev)
    in1, nc = encode_fused.prep(data_dev, blens_dev)
    ow = encode_fused.ocap(BS)
    kern_ms = time_ms(lambda: encode_fused._launch(data_dev, blens_dev, in1, nc, ow))
    prep_ms = time_ms(lambda: encode_fused.prep(data_dev, blens_dev))
    enc_ms = time_ms(lambda: encode_fused._launch(
        data_dev, blens_dev, *encode_fused.prep(data_dev, blens_dev), ow))
    enc_plain = _host_ms(lambda: encode_fused.encode_blocks(data, blens, device="cpu"))

    rows = []
    # bytes each function must move: every input tensor read once (per-block
    # offsets, lengths and limits included), every output tensor written once
    nseg = len(offs)
    for name, replaces, ms, plain_ms, nin, nout, steps, err in (
        ("decode_blocks", "csnappy_tpu/ops/decode_fused.py:714", dec_ms, dec_plain,
         int(lens.sum()) + 16 * B, B * BS + 8 * B, max(tags), err_dec),
        ("decode_segments", "csnappy_tpu/ops/decode_fused.py:782", seg_ms, seg_plain,
         len(body) + 16 * nseg, nseg * BS + 8 * nseg, max(seg_tags), err_seg),
        ("encode_blocks", "csnappy_tpu/ops/encode_fused.py:602", enc_ms, enc_plain,
         B * BS + 4 * B, B * ow + 8 * B, max(commits), err_enc),
    ):
        bound_ms, bound_by = _bound(nin + nout)
        src = "csnappy_tpu_torch/csrc/" + ("encode" if name == "encode_blocks" else "decode") \
            + "_blocks.cu"
        useful = B * BS if name != "decode_segments" else len(urls)   # uncompressed bytes
        row = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
               "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None, "GBps": useful / (ms * 1e-3) / 1e9,
               "bytes": nin + nout, "chain_steps": steps}
        if name == "encode_blocks":
            row.update(kernel_ms=kern_ms, prep_ms=prep_ms)
        rows.append(row)
        print(f"[times] {name}: {ms:.4f} ms ({row['GBps']:.3f} GB/s of uncompressed bytes), "
              f"plain {plain_ms:.1f} ms (host CPU), bound {row['bound_ms']:.5f} ms by "
              f"{row['bound_by']} ({nin + nout} B), serial chain {steps} steps"
              + (f"; kernel {kern_ms:.4f} ms + prep {prep_ms:.4f} ms"
                 if name == "encode_blocks" else ""), flush=True)
    print(f"[times] card {name_}, power limit {power_}, max SM clock {clock_}", flush=True)

    # -------------------------------------------------- 6. whole streams
    rows += _whole_stream(torch, np, dev, urls, golden, unaligned, card)

    # -------------------------------- 7-10. container, fixture, CLI, movebench
    container_launches = _container(torch, np, dev, card)
    for row in rows:
        if row["name"] in container_launches:
            row["launches_container"] = container_launches[row["name"]]
    _container_fixture(np, dev)
    _cli(urls, golden, fixture)
    rows += _movebench(torch, np, dev, card)

    # ----------------------------------------------------- 11. primitives
    rows += _primitives(torch, np, dev, card)

    # --------------------------------------------------------- 12. probes
    probe_rows, recs = _probes(torch, np, dev, card)
    rows += probe_rows
    step = recs["mosaic_probe.walk_smem"]["cycles_per_iter"]
    step_ms = step / (float(clock_.split()[0]) * 1e3)     # cycles at the max SM clock
    for row in rows:
        if "chain_steps" in row and row["route"] == "cuda":
            print(f"[chain] {row['name']}: {row['chain_steps']} serial steps x one walk_smem step "
                  f"({step:.2f} SM cycles at {clock_}: a dependent shared load and four integer "
                  f"operations, not a floor) = {row['chain_steps'] * step_ms:.4f} ms; the kernel "
                  f"{row['ms']:.4f} ms", flush=True)

    # ------------------------------------------------------- 13. kernel_lib
    rows += _kernel_lib(torch, np, dev, card)

    # --------------------------------------------------------- 14. result
    print(json.dumps({"kernels": rows}), flush=True)
    print(_smi("name,power.limit"), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
