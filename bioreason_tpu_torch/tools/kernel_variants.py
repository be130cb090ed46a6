"""Time design variants of the attention kernels against each other on one
CUDA card.

    python3 -m bioreason_tpu_torch.tools.kernel_variants [entry ...]

Builds csrc/flash_fwd.cu and csrc/flash_bwd.cu as they are and with each
named text change of `VARIANTS` (one nvcc each, run together), and times
each build through the port's own wrappers (`flash_attention`, `flash_bwd`,
`local_attention`, `local_bwd`, with the build's C entry in place of the
library's) at the main path's shapes with CUDA events: each build in its
own process, in the order as_is, variants..., variants reversed..., as_is,
so drift of the card shows. The entries named on the command line (C entry
names without `_bf16`: flash_fwd, flash_bwd, local_fwd, local_bwd) are
timed, all by default. A banded entry's source is the flash source that
holds it (`flash_attention._LIBRARY_OF`), so a text change there applies to
both kernels of the source. Each timing also gives the largest error
against the plain version, relative to the largest |ref| (a variant that
drops work, like no_dq, is wrong on purpose). Prints the card and one JSON
line per pass.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from bioreason_tpu_torch.ops import cuda_build
from bioreason_tpu_torch.ops.flash_attention import _LIBRARY_OF

REPO = Path(__file__).resolve().parents[2]
# the per-pair predicate on every tile, not only where a pair is invalid
_FWD_MASK_ALWAYS = [("if (need) softmax_tile<true, BAND>(", "if (true) softmax_tile<true, BAND>(")]
_BWD_MASK_ALWAYS = [("if (need) p_and_ds<true, BAND>(", "if (true) p_and_ds<true, BAND>(")]
# (C entry, variant) -> text replacements applied to the source that holds it
VARIANTS = {
    ("flash_fwd", "as_is"): [],
    # q tiles in launch order from the first (fewest keys) to the last
    ("flash_fwd", "ascending"): [("const int qt = n_qt - 1 - (int)(blockIdx.x / per);",
                                  "const int qt = (int)(blockIdx.x / per);")],
    # the two consumer warpgroups issue their products without taking turns
    ("flash_fwd", "no_pingpong"): [("if (cw == 1) sm90::named_barrier_arrive(1, 256);", ""),
                                   ("sm90::named_barrier(turn, 256);", ""),
                                   ("sm90::named_barrier_arrive(other, 256);", "")],
    # a K/V ring of two stages instead of three
    ("flash_fwd", "stages2"): [("constexpr int STAGES = 3;        // K/V ring depth",
                                "constexpr int STAGES = 2;        // K/V ring depth")],
    # the output rows rescaled on every tile, not only when a row maximum moved
    ("flash_fwd", "rescale_always"): [("if (alpha[0] != 1.f || alpha[1] != 1.f) {", "{")],
    ("flash_fwd", "mask_always"): _FWD_MASK_ALWAYS,
    ("flash_bwd", "as_is"): [],
    ("flash_bwd", "mask_always"): _BWD_MASK_ALWAYS,
    ("flash_bwd", "exp2f"): [("sm90::exp2_approx(", "exp2f(")],
    # dk and dv only: the dQ product and its reduce-add are skipped
    ("flash_bwd", "no_dq"): [("      const int buf = it & 1;\n",
                              "      continue;\n      const int buf = it & 1;\n")],
    ("local_fwd", "as_is"): [],
    # the band's predicate on every tile, also on the interior ones
    ("local_fwd", "mask_always"): _FWD_MASK_ALWAYS,
    ("local_bwd", "as_is"): [],
    ("local_bwd", "mask_always"): _BWD_MASK_ALWAYS,
}
# flash entries: (name, B, Tq, Tk, Hq, Hkv, D, causal); banded entries:
# (name, B, T, Hq, Hkv, D, window, shortest valid length of the right pads)
_BAND_SHAPES = [("b_encoder_long_T2048_W256", 4, 2048, 16, 16, 64, 256, 1024),
                ("e_encoder_T344_W4096", 16, 344, 16, 16, 64, 4096, 200)]
SHAPES = {
    "flash_fwd": [("dec_long_T4608", 2, 4608, 4608, 16, 8, 128, True),
                  ("prefill_P896", 8, 896, 960, 16, 8, 128, True),
                  ("sft_T768", 4, 768, 768, 16, 8, 128, True),
                  ("encoder_T344", 16, 344, 344, 16, 16, 64, False),
                  ("encoder_T2048", 4, 2048, 2048, 16, 16, 64, False)],
    "flash_bwd": [("dec_long_T4608", 2, 4608, 4608, 16, 8, 128, True),
                  ("sft_T768", 4, 768, 768, 16, 8, 128, True),
                  ("encoder_T2048", 4, 2048, 2048, 16, 16, 64, False)],
    "local_fwd": _BAND_SHAPES,
    "local_bwd": _BAND_SHAPES,
}


def build(out_dir: Path, entries) -> dict:
    """(entry, variant) -> shared library of that build, for `entries`."""
    procs, libs = {}, {}
    for (entry, name), changes in VARIANTS.items():
        if entry not in entries:
            continue
        src_dir = out_dir / f"{entry}-{name}"
        shutil.copytree(cuda_build.CSRC_DIR, src_dir)
        src = src_dir / f"{_LIBRARY_OF[entry]}.cu"
        text = src.read_text()
        for old, new in changes:
            if old not in text:
                raise RuntimeError(f"{entry} {name}: {old!r} is not in {src.name}")
            text = text.replace(old, new)
        src.write_text(text)
        libs[entry, name] = out_dir / f"lib{entry}-{name}.so"
        procs[entry, name] = subprocess.Popen(
            [cuda_build.cuda_tool("nvcc"), *cuda_build.NVCC_FLAGS, "-o",
             str(libs[entry, name]), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for key, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
    return libs


def _calls(entry, shape):
    """(call, the plain version's outputs) of `entry` at one shape."""
    import torch
    from bioreason_tpu_torch.ops import flash_attention as fa
    from bioreason_tpu_torch.ops import local_attention as la
    g = torch.Generator(device="cuda").manual_seed(0)
    if entry.startswith("local"):
        _, b, t, hq, hkv, d, window, lo = shape
        tq = tk = t
        lens = torch.randint(lo, t + 1, (b,), generator=g, device="cuda")
        mask = (torch.arange(t, device="cuda")[None, :] < lens[:, None]).to(torch.int32)
    else:
        _, b, tq, tk, hq, hkv, d, causal = shape
        mask = torch.ones((b, tk), dtype=torch.int32, device="cuda")
    q, k, v, do = (torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
                   for s in ((b, tq, hq, d), (b, tk, hkv, d), (b, tk, hkv, d), (b, tq, hq, d)))
    if entry == "flash_fwd":
        return (lambda: (fa.flash_attention(q, k, v, mask, causal=causal, q_offset=0),),
                fa.flash_attention_ref(q, k, v, mask, causal, 0)[:1])
    if entry == "flash_bwd":
        o, lse = fa.flash_attention_ref(q, k, v, mask, causal, 0)
        return (lambda: fa.flash_bwd(q, k, v, mask, causal, 0, o, lse, do),
                fa.flash_attention_bwd_ref(q, k, v, mask, causal, 0, o, lse, do))
    if entry == "local_fwd":
        return (lambda: (la.local_attention(q, k, v, window, mask),),
                la.local_attention_ref(q, k, v, window, mask)[:1])
    o, lse = la.local_attention_ref(q, k, v, window, mask)
    return (lambda: la.local_bwd(q, k, v, window, mask, o, lse, do),
            la.local_attention_bwd_ref(q, k, v, window, mask, o, lse, do))


def time_build(entry: str, path: str) -> dict:
    """ms per wrapper call with the C entry of `path`, and the error."""
    import torch
    from bioreason_tpu_torch.ops import flash_attention as fa
    fn = getattr(ctypes.CDLL(path), f"{entry}_bf16")
    fn.argtypes, fn.restype = fa._ARGTYPES[entry], ctypes.c_int
    fa._fns[entry] = fn
    out = {}
    for shape in SHAPES[entry]:
        call, refs = _calls(entry, shape)
        got = call()
        err = max(float((a.float() - r.float()).abs().max() / r.float().abs().max())
                  for a, r in zip(got, refs))
        for _ in range(3):
            call()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            call()
        end.record()
        torch.cuda.synchronize()
        out[shape[0]] = {"ms": start.elapsed_time(end) / 20, "rel_err": err}
    return out


def main():
    if len(sys.argv) == 4 and sys.argv[1] == "--time":
        print(json.dumps(time_build(sys.argv[2], sys.argv[3])), flush=True)
        return
    entries = sys.argv[1:] or list(SHAPES)
    unknown = [e for e in entries if e not in SHAPES]
    if unknown:
        raise SystemExit(f"unknown entries {unknown}: choose from {list(SHAPES)}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as tmp:
        libs = build(Path(tmp), entries)
        for entry in entries:
            names = [n for e, n in VARIANTS if e == entry]
            for name in names + names[::-1]:
                res = subprocess.run(
                    [sys.executable, "-m", __spec__.name, "--time", entry, str(libs[entry, name])],
                    capture_output=True, text=True, timeout=600,
                    env={**os.environ, "PYTHONPATH": str(REPO)})
                if res.returncode != 0:
                    raise RuntimeError(f"{entry} {name}: {res.stderr[-2000:]}")
                print(json.dumps({"entry": entry, "variant": name, "card": card,
                                  **json.loads(res.stdout.strip().splitlines()[-1])}), flush=True)


if __name__ == "__main__":
    main()
