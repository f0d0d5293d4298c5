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
             and printed beside it, with a design-floor estimate of its
             time from an assumed shared-memory load latency (printed only,
             never in the ``kernels`` line, which holds measured numbers);
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
             offset-40000 stream through ``decode_jnp``; then times on the
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
10. movebench — rows 12-13 (``csrc/movebench.cu``: the flat gather and the
             max-scan) against their plain versions at n = 32768 and 2^24
             with 0 differing elements, timed beside the library call
             (``tbl.view(-1)[idx]``, ``torch.cummax``) and the bound (12n and
             8n bytes over 3.35 TB/s); then ``movebench.main()`` with their
             launch counts set to 0, printing its five strategy lines;
11. the ``kernels`` JSON line, the card's name and power limit, and the
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
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (NVIDIA data sheet)
OPS_PER_S = 67e12             # H100 SXM 32-bit rate outside the tensor cores
SMEM_LOAD_CYCLES = 30         # dependent shared-memory load latency per chain step (assumed)
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
    try:
        for w in counted.values():
            w.launches = 0
        for route, fn, want in (
                ("urls.10K.snappy", lambda: api.decompress(golden), urls),
                ("unaligned_uint64_test.snappy", lambda: api.decompress(
                    (DATA / "unaligned_uint64_test.snappy").read_bytes()), unaligned),
                ("copy4_offset_40000", lambda: api.decompress_noheader(bytes(far), len(lit) + 8),
                 lit + lit[-40000 : -40000 + 8]),
                ("urls.10K x24", lambda: api.decompress(big_comp), big)):
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


def _movebench(torch, np, dev, card: str) -> list:
    """Phase 10: rows 12-13 (``csrc/movebench.cu``) against their plain
    versions at n = 32768 and 2^24 with 0 differing elements, timed beside
    the library call and the bound; then ``movebench.main()`` with launch
    counts set to 0."""
    from csnappy_tpu_torch.tools import movebench as mb
    from csnappy_tpu_torch.tools.timing import time_ms

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
        for name, ms, lib_ms, plain, nbytes in (
                ("gather_flat", time_ms(lambda: mb.gather_flat(tbl, idx, 16, dev)),
                 time_ms(lambda: ftbl[fidx]), plain_g, 12 * n),
                ("scan_max", time_ms(lambda: mb.scan_max(x, dev)),
                 time_ms(lambda: torch.cummax(fx, 0)), plain_s, 8 * n)):
            bound_ms, bound_by = _bound(nbytes)
            print(f"[movebench] {name} n={n}: {ms:.4f} ms, library {lib_ms:.4f} ms, plain "
                  f"{plain:.2f} ms (host CPU), bound {bound_ms:.5f} ms by {bound_by} "
                  f"({nbytes} B); 0 of {n} elements differ", flush=True)
            if n == 32768:
                rows[name] = {"name": name, "route": "cuda",
                              "source": "csnappy_tpu_torch/csrc/movebench.cu",
                              "replaces": "csnappy_tpu/tools/movebench.py:"
                                          + ("62" if name == "gather_flat" else "92"),
                              "launches": 0, "max_abs_err": err[name], "ms": ms,
                              "plain_ms": plain,
                              "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                              "bytes": nbytes}
            else:
                rows[name].update(ms_n16M=ms, library_ms_n16M=lib_ms, plain_ms_n16M=plain,
                                  bound_ms_n16M=bound_ms)
    mb.gather_flat.launches = mb.scan_max.launches = 0
    assert mb.main([]) == 0                                   # device=None: the card
    for name, w in (("gather_flat", mb.gather_flat), ("scan_max", mb.scan_max)):
        assert w.launches > 0, name
        rows[name]["launches"] = w.launches
    print(f"[movebench] main(): launches gather_flat {mb.gather_flat.launches}, scan_max "
          f"{mb.scan_max.launches}; card {card}", flush=True)
    return list(rows.values())


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
    step_ns = SMEM_LOAD_CYCLES / (float(clock_.split()[0]) * 1e6) * 1e9
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
        chain_ms = steps * step_ns * 1e-6
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
              f"{row['bound_by']} ({nin + nout} B), serial chain {steps} steps, design-floor "
              f"estimate {chain_ms:.4f} ms at an assumed {SMEM_LOAD_CYCLES} cycles a step"
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

    # --------------------------------------------------------- 11. result
    print(json.dumps({"kernels": rows}), flush=True)
    print(_smi("name,power.limit"), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
