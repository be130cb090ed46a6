"""Generate reasoning traces for curated variant rows, locally (the port of
bioreason_tpu/cli/make_traces.py).

The reference's `BioReasoning_DataCuration_KEGG.ipynb` does this with the
Anthropic API (batched requests, temperature 0.2, "VALID JSON only"); here
the traces come from a deterministic template or from the port's own
generation engine over a local model, with optional guided decoding that
pins the output to the JSON skeleton (data/traces.py).

    # offline, no model:
    python -m bioreason_tpu_torch.cli.make_traces \\
        --tsv final_network_with_variant.tsv --out analyses.json

    # with a trained checkpoint, on the card:
    python -m bioreason_tpu_torch.cli.make_traces --tsv ... --backend engine \\
        --checkpoint checkpoints/sft_final --out analyses.json \\
        --items_out kegg_items.jsonl

`--items_out` also writes the analyses as KEGG-dataset items (question /
answer / reasoning) for `cli.train_sft --data_dir`. The engine backend runs
on `--device` (CUDA unless "cpu"); its model is `--checkpoint` (the port's
sft_final, its base rebuilt from its metadata and its adapters merged, or
kept beside a QLoRA base's int8 weights, as `serve --checkpoint` builds
it), else the pretrained `--hf_llm_dir` / `--hf_dna_dir`, else the presets'
weights drawn from `--seed`.
"""

from __future__ import annotations

import argparse
import json
from collections import Counter


def parse_args(argv=None):
    from bioreason_tpu_torch.cli.common import DECODER_PRESETS, ENCODER_PRESETS
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--tsv", required=True,
                   help="KEGG network-with-variant TSV (Var_ID, ENTRY, Chr, Start, RefAllele, "
                        "AltAllele, Network Definition, Gene, Disease columns)")
    p.add_argument("--out", required=True,
                   help="combined analyses JSON (all_variant_analyses.json equivalent)")
    p.add_argument("--items_out", default=None,
                   help="also write KEGG-format items JSONL for SFT")
    p.add_argument("--backend", default="template", choices=["template", "engine"])
    p.add_argument("--num", type=int, default=None, help="process only the first N rows")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_new_tokens", type=int, default=512)
    p.add_argument("--answer_col", default=None,
                   help="TSV column holding a curated ground-truth answer to rationalize "
                        "(teacher forcing)")
    p.add_argument("--guided_json", action="store_true",
                   help="constrain engine output to the JSON skeleton (guided decoding)")
    p.add_argument("--decoder", default="qwen3-0.6b", choices=sorted(DECODER_PRESETS))
    p.add_argument("--encoder", default="nt-500m", choices=sorted(ENCODER_PRESETS))
    p.add_argument("--hf_llm_dir", default=None)
    p.add_argument("--hf_dna_dir", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="the port's sft_final (or sft_state) directory to generate with")
    p.add_argument("--frozen", default="int8", choices=["bfloat16", "int8"],
                   help="engine weight storage (int8 = the serving configuration)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights and of the sampler")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    """Write the analyses (and items); returns them."""
    from bioreason_tpu_torch.data import traces
    args = parse_args(argv)
    rows = traces.load_variant_tsv(args.tsv)
    if args.num is not None:
        rows = rows[:args.num]
    answers = [r.get(args.answer_col, "") for r in rows] if args.answer_col else None
    print(f"loaded {len(rows)} variant rows from {args.tsv}")

    if args.backend == "template":
        analyses = traces.generate_analyses(rows, backend="template", known_answers=answers)
    else:
        analyses = _engine_analyses(args, rows, answers)

    traces.combine_analyses(analyses, args.out)
    counts = Counter(a["backend"] for a in analyses)
    print(f"wrote {len(analyses)} analyses to {args.out} ({dict(counts)})")
    if args.items_out:
        with open(args.items_out, "w", encoding="utf-8") as f:
            for a in analyses:
                f.write(json.dumps(traces.analysis_to_item(a)) + "\n")
        print(f"wrote KEGG items to {args.items_out}")
    return analyses


def engine_model(args, device):
    """(FusionConfig, model, processor) of the engine backend."""
    from bioreason_tpu_torch.cli.common import DECODER_PRESETS, ENCODER_PRESETS
    from bioreason_tpu_torch.config import FusionConfig
    from bioreason_tpu_torch.data import BioProcessor, ByteTextTokenizer, KmerTokenizer
    from bioreason_tpu_torch.models.fusion import init_fusion
    if args.checkpoint:
        from bioreason_tpu_torch.serve import checkpoint_model
        return checkpoint_model(args.checkpoint, device)
    if args.hf_llm_dir:
        from bioreason_tpu_torch.utils.pretrained import load_pretrained_fusion
        if not args.hf_dna_dir:
            raise SystemExit("--hf_llm_dir requires --hf_dna_dir")
        cfg, model, tok, dna_tok = load_pretrained_fusion(args.hf_llm_dir, args.hf_dna_dir,
                                                          seed=args.seed, device=device)
        return cfg, model, BioProcessor(tok, dna_tok)
    tok = ByteTextTokenizer()
    cfg = FusionConfig(decoder=DECODER_PRESETS[args.decoder](vocab_size=tok.vocab_size),
                       encoder=ENCODER_PRESETS[args.encoder](), dna_pad_token_id=tok.dna_pad_id)
    return cfg, init_fusion(cfg, seed=args.seed, device=device), BioProcessor(tok, KmerTokenizer())


def _engine_analyses(args, rows, answers):
    import torch

    from bioreason_tpu_torch.config import SamplingConfig
    from bioreason_tpu_torch.data import traces
    from bioreason_tpu_torch.generate.engine import GenerationEngine
    from bioreason_tpu_torch.serve import serving_storage
    from bioreason_tpu_torch.utils.devices import resolve_device

    device = resolve_device(args.device)
    cfg, model, processor = engine_model(args, device)
    model.requires_grad_(False)
    if args.frozen == "int8":
        serving_storage(model, int8=True)
    engine = GenerationEngine(cfg, eos_token_id=processor.text_tokenizer.eos_token_id,
                              device=device)
    guided = None
    if args.guided_json:
        from bioreason_tpu_torch.generate.guided import guided_spec_for
        guided = guided_spec_for(processor.text_tokenizer, traces.guided_regex_for_analysis(),
                                 vocab_size=cfg.decoder.vocab_size, device=device)
    return traces.generate_analyses(
        rows, backend="engine", known_answers=answers, engine=engine, model=model,
        processor=processor, sampling=SamplingConfig(temperature=0.2, top_k=50, top_p=0.95),
        max_new_tokens=args.max_new_tokens, batch_size=args.batch_size, guided=guided,
        generator=torch.Generator(device=device).manual_seed(args.seed))


if __name__ == "__main__":
    main()
