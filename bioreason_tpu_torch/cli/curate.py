"""Dataset curation CLI: FASTA genome + variant table -> training JSONL (the
port of bioreason_tpu/cli/curate.py).

The computational equivalent of the reference's curation notebooks
(data/*.ipynb, SURVEY §2.1 'Data curation pipeline'): the network fetches
(KEGG/ClinVar/Ensembl APIs, Claude-generated reasoning traces) happen
upstream; this turns locally-available genome + variant tables into the
(question, answer, reference_sequence, variant_sequence[, reasoning]) items
the loaders and trainers consume.

Example:
  python -m bioreason_tpu_torch.cli.curate --fasta genome.fa --variants vars.tsv \
      --task variant_effect_coding --flank 1000 --out train.jsonl
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--fasta", default=None,
                   help="genome/contigs FASTA (optional for eqtl/omim rows "
                        "that already carry ref/alt sequence columns)")
    p.add_argument("--variants", default=None,
                   help="TSV: chrom, pos (1-based), ref, alt, answer"
                        "[, gene][, reasoning]; eqtl/omim tables may instead "
                        "carry ref_forward_sequence/alt_forward_sequence "
                        "(+ tissue, chromosome, label) hub-style columns")
    p.add_argument("--task", default="kegg",
                   choices=["kegg", "variant_effect_coding",
                            "variant_effect_non_snv", "eqtl", "omim"])
    p.add_argument("--split", default=None,
                   help="eqtl/omim: split name baked into record IDs "
                        "(Task2_{split}_{i}; defaults: eqtl=train, omim=test)")
    p.add_argument("--seed", type=int, default=0,
                   help="eqtl/omim: question-paraphrase selection seed")
    p.add_argument("--flank", type=int, default=1000,
                   help="window half-width in nt (reference uses ±1000)")
    p.add_argument("--out", required=True, help="output JSONL path")
    p.add_argument("--skip_mismatches", action="store_true",
                   help="drop rows whose ref allele mismatches the genome "
                        "instead of raising")
    p.add_argument("--clinvar", action="store_true",
                   help="treat --variants as a ClinVar variant_summary-style "
                        "TSV (Chromosome/PositionVCF/*AlleleVCF/"
                        "ClinicalSignificance/GeneSymbol/Type columns): rows "
                        "are split SNV vs non-SNV by Type and answers are "
                        "cleaned with the VEP dataset-layer cleaners "
                        "(Clinvar_Coding / Clinvar_SNV_Non_SNV notebook tail)")
    p.add_argument("--assembly", default=None,
                   help="with --clinvar: keep only rows of this Assembly "
                        "(e.g. GRCh38)")
    p.add_argument("--kegg_api_cache", default=None,
                   help="KEGG-network retrieval mode: run the KEGG_Data_1 "
                        "pipeline (list networks -> pull entries -> variant "
                        "elements -> Ensembl coordinates) from this response-"
                        "cache directory (data/retrieval.py; offline replay "
                        "— populate the cache where egress exists)")
    p.add_argument("--networks", nargs="*", default=None,
                   help="with --kegg_api_cache: restrict to these network "
                        "ids instead of listing all")
    args = p.parse_args(argv)

    from bioreason_tpu_torch.data.curation import (curate_clinvar, curate_eqtl,
                                             curate_items, curate_omim,
                                             read_clinvar_table, read_fasta,
                                             read_task_table,
                                             read_variant_table, write_jsonl)
    contigs = read_fasta(args.fasta) if args.fasta else None
    if args.kegg_api_cache:
        # Retrieval mode: KEGG_Data_1's list -> pull -> variant elements ->
        # Ensembl coordinates pipeline, replayed from the response cache.
        if contigs is None:
            p.error("--kegg_api_cache requires --fasta for the windows step")
        from bioreason_tpu_torch.data.retrieval import (DirCacheTransport,
                                                  EnsemblVariationClient,
                                                  KeggClient,
                                                  retrieve_network_variant_rows)
        transport = DirCacheTransport(args.kegg_api_cache)
        rows = retrieve_network_variant_rows(
            KeggClient(transport), EnsemblVariationClient(transport),
            network_ids=args.networks)
        unresolved = [r for r in rows if not r["chrom"]]
        rows = [r for r in rows if r["chrom"]]
        items = curate_items(contigs, rows, task="kegg", flank=args.flank,
                             validate_ref=not args.skip_mismatches)
        write_jsonl(items, args.out)
        print(f"wrote {len(items)} items to {args.out} "
              f"({len(unresolved)} variant elements left unresolved: "
              f"non-dbSNP/COSM refs need their own databases)")
        return
    if args.variants is None:
        p.error("--variants is required (or use --kegg_api_cache)")
    if args.task in ("eqtl", "omim"):
        # VEP.ipynb tasks 2/3: hub-schema records (ID, question, answer,
        # reference_sequence, variant_sequence) from a task table
        rows = read_task_table(args.variants)
        fn = curate_eqtl if args.task == "eqtl" else curate_omim
        split = args.split or ("train" if args.task == "eqtl" else "test")
        items = fn(rows, split=split, contigs=contigs, flank=args.flank,
                   seed=args.seed, validate_ref=not args.skip_mismatches)
        write_jsonl(items, args.out)
        print(f"wrote {len(items)} items to {args.out}")
        return
    if args.fasta is None:
        p.error(f"--task {args.task} requires --fasta")
    if args.clinvar:
        if args.task == "kegg":
            p.error("--clinvar emits VEP tasks; pick --task "
                    "variant_effect_coding or variant_effect_non_snv")
        rows = read_clinvar_table(args.variants, assembly=args.assembly)
        items = curate_clinvar(contigs, rows, task=args.task,
                               flank=args.flank,
                               validate_ref=not args.skip_mismatches)
    else:
        rows = read_variant_table(args.variants)
        items = curate_items(contigs, rows, task=args.task, flank=args.flank,
                             validate_ref=not args.skip_mismatches)
    write_jsonl(items, args.out)
    print(f"wrote {len(items)} items ({len(rows) - len(items)} dropped) "
          f"to {args.out}")


if __name__ == "__main__":
    main()
