"""Time design variants of the flash kernels against each other on one CUDA
card.

    python3 -m bioreason_tpu_torch.tools.kernel_variants

Builds csrc/flash_fwd.cu and csrc/flash_bwd.cu as they are and with each
named text change of `VARIANTS` (one nvcc each, run together), and times
each build through the port's own wrappers (`flash_attention`, `flash_bwd`,
with the build's C entry in place of the library's) at the main path's
shapes with CUDA events: each build in its own process, in the order as_is,
variants..., variants reversed..., as_is, so drift of the card shows. Each
timing also gives the largest error against the plain version, relative to
the largest |ref| (a variant that drops work, like no_dq, is wrong on
purpose). Prints the card and one JSON line per pass.
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

REPO = Path(__file__).resolve().parents[2]
# (C entry, variant) -> text replacements applied to csrc/<entry>.cu
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
    # the per-pair predicate on every tile, not only where a pair is invalid
    ("flash_fwd", "mask_always"): [("if (need) softmax_tile<true>(",
                                     "if (true) softmax_tile<true>(")],
    ("flash_bwd", "as_is"): [],
    ("flash_bwd", "mask_always"): [("if (need) p_and_ds<true>(", "if (true) p_and_ds<true>(")],
    ("flash_bwd", "exp2f"): [("sm90::exp2_approx(", "exp2f(")],
    # dk and dv only: the dQ product and its reduce-add are skipped
    ("flash_bwd", "no_dq"): [("      const int buf = it & 1;\n",
                              "      continue;\n      const int buf = it & 1;\n")],
}
# entry -> (name, B, Tq, Tk, Hq, Hkv, D, causal)
SHAPES = {
    "flash_fwd": [("dec_long_T4608", 2, 4608, 4608, 16, 8, 128, True),
                  ("prefill_P896", 8, 896, 960, 16, 8, 128, True),
                  ("sft_T768", 4, 768, 768, 16, 8, 128, True),
                  ("encoder_T344", 16, 344, 344, 16, 16, 64, False),
                  ("encoder_T2048", 4, 2048, 2048, 16, 16, 64, False)],
    "flash_bwd": [("dec_long_T4608", 2, 4608, 4608, 16, 8, 128, True),
                  ("sft_T768", 4, 768, 768, 16, 8, 128, True),
                  ("encoder_T2048", 4, 2048, 2048, 16, 16, 64, False)],
}


def build(out_dir: Path) -> dict:
    """(entry, variant) -> shared library of that build."""
    procs, libs = {}, {}
    for (entry, name), changes in VARIANTS.items():
        src_dir = out_dir / f"{entry}-{name}"
        shutil.copytree(cuda_build.CSRC_DIR, src_dir)
        src = src_dir / f"{entry}.cu"
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


def time_build(entry: str, path: str) -> dict:
    """ms per wrapper call with the C entry of `path`, and the error."""
    import torch
    from bioreason_tpu_torch.ops import flash_attention as fa
    fn = getattr(ctypes.CDLL(path), f"{entry}_bf16")
    fn.argtypes, fn.restype = fa._ARGTYPES[entry], ctypes.c_int
    fa._fns[entry] = fn
    out = {}
    for name, b, tq, tk, hq, hkv, d, causal in SHAPES[entry]:
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
                       for s in ((b, tq, hq, d), (b, tk, hkv, d), (b, tk, hkv, d),
                                 (b, tq, hq, d)))
        mask = torch.ones((b, tk), dtype=torch.int32, device="cuda")
        ref_o, ref_lse = fa.flash_attention_ref(q, k, v, mask, causal, 0)
        if entry == "flash_fwd":
            def call():
                return fa.flash_attention(q, k, v, mask, causal=causal, q_offset=0)
            refs = (ref_o,)
        else:
            def call():
                return fa.flash_bwd(q, k, v, mask, causal, 0, ref_o, ref_lse, do)
            refs = fa.flash_attention_bwd_ref(q, k, v, mask, causal, 0, ref_o, ref_lse, do)
        got = call()
        got = (got,) if entry == "flash_fwd" else got
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
        out[name] = {"ms": start.elapsed_time(end) / 20, "rel_err": err}
    return out


def main():
    if len(sys.argv) == 4 and sys.argv[1] == "--time":
        print(json.dumps(time_build(sys.argv[2], sys.argv[3])), flush=True)
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as tmp:
        libs = build(Path(tmp))
        for entry in SHAPES:
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
