"""Data-curation helpers: variant windows and sequence construction (the
port's own copy of bioreason_tpu/data/curation.py, which it does not import).

The reference's curation layer (data/*.ipynb, SURVEY §2.1 'Data curation
pipeline') fetches KEGG/ClinVar/Ensembl records and builds (reference,
variant) sequence windows of ±1000 nt around each variant. The network/API
plumbing is out of scope here; this module provides the COMPUTATIONAL core so
locally-available genome/variant tables can be turned into training items:

  * `extract_window`  — ±flank window around a position, clamped to bounds
  * `apply_variant`   — SNV/insertion/deletion/indel application with
                        reference-allele validation
  * `build_variant_item` — (window_ref, window_alt, metadata) -> canonical
                        training-item dict consumed by data/loaders.py
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional


@dataclass(frozen=True)
class Variant:
    position: int          # 0-based position in the chromosome/contig string
    ref_allele: str        # "" for pure insertions
    alt_allele: str        # "" for pure deletions


def extract_window(sequence: str, position: int, flank: int = 1000) -> tuple[str, int]:
    """Return (window, offset_of_position_in_window), clamped at bounds."""
    start = max(0, position - flank)
    end = min(len(sequence), position + flank)
    return sequence[start:end], position - start


def apply_variant(window: str, offset: int, variant: Variant,
                  validate: bool = True) -> str:
    """Apply an SNV/ins/del/indel at `offset` within `window`."""
    ref = variant.ref_allele.upper()
    alt = variant.alt_allele.upper()
    if validate and ref:
        found = window[offset:offset + len(ref)].upper()
        if found != ref:
            raise ValueError(
                f"reference allele mismatch at offset {offset}: "
                f"expected {ref!r}, found {found!r}")
    return window[:offset] + alt + window[offset + len(ref):]


def build_variant_item(chrom_sequence: str, variant: Variant, question: str,
                       answer: str, reasoning: str = "", flank: int = 1000,
                       metadata: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Canonical training item from a contig + variant (loaders.py layout)."""
    window, offset = extract_window(chrom_sequence, variant.position, flank)
    alt_window = apply_variant(window, offset, variant)
    item = {
        "question": question,
        "answer": answer.strip().lower(),
        "reasoning": reasoning,
        "reference_sequence": window.upper(),
        "variant_sequence": alt_window.upper(),
    }
    if metadata:
        item.update(metadata)
    return item


# ---------------------------------------------------------------------------
# Local end-to-end curation (the computational equivalent of the reference's
# KEGG_Data_2/3 + Clinvar notebooks, minus the network fetches — SURVEY §2.1
# 'Data curation pipeline'): FASTA genome + variant table -> training JSONL
# consumable by data/loaders.py.
# ---------------------------------------------------------------------------

QUESTION_TEMPLATES = {
    # phrasing mirrors the task framing of the curated datasets (ref/variant
    # sequences + task question -> reasoned answer; SURVEY §0)
    "kegg": ("Given the reference and variant DNA sequences, which biological "
             "pathway is most likely to be disrupted by this variant{gene}?"),
    "variant_effect_coding": (
        "Given the reference and variant DNA sequences, is this coding "
        "variant most likely pathogenic or benign{gene}?"),
    "variant_effect_non_snv": (
        "Given the reference and variant DNA sequences, is this structural "
        "variant most likely pathogenic or benign{gene}?"),
}


def read_fasta(path: str) -> Dict[str, str]:
    """Minimal FASTA reader: {contig_name: sequence} (name = first token)."""
    contigs: Dict[str, list] = {}
    name = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                name = line[1:].split()[0]
                contigs[name] = []
            else:
                if name is None:
                    raise ValueError("FASTA sequence before header")
                contigs[name].append(line)
    return {k: "".join(v) for k, v in contigs.items()}


def read_variant_table(path: str) -> list:
    """TSV with header: chrom, pos (1-based), ref, alt, answer[, gene][, reasoning].
    Comment lines (#) skipped. Returns list of row dicts."""
    import csv
    rows = []
    with open(path) as f:
        reader = csv.DictReader(
            (l for l in f if not l.startswith("#")), delimiter="\t")
        required = {"chrom", "pos", "ref", "alt", "answer"}
        missing = required - set(reader.fieldnames or ())
        if missing:
            raise ValueError(f"variant table missing columns: {sorted(missing)}")
        for row in reader:
            rows.append(row)
    return rows


def curate_items(contigs: Dict[str, str], rows: list, task: str = "kegg",
                 flank: int = 1000, validate_ref: bool = True) -> list:
    """Variant rows -> canonical training items (ref/alt ±flank windows,
    task question template, lower-cased answer). Rows whose reference allele
    does not match the genome raise (validate_ref=False to skip instead)."""
    template = QUESTION_TEMPLATES[task]
    items = []
    for row in rows:
        chrom = row["chrom"]
        if chrom not in contigs:
            raise KeyError(f"contig {chrom!r} not in FASTA")
        gene = row.get("gene") or ""
        question = template.format(gene=f" in gene {gene}" if gene else "")
        variant = Variant(position=int(row["pos"]) - 1,
                          ref_allele=row["ref"].replace("-", ""),
                          alt_allele=row["alt"].replace("-", ""))
        try:
            item = build_variant_item(
                contigs[chrom], variant, question, row["answer"],
                reasoning=row.get("reasoning", ""), flank=flank,
                metadata={"gene": gene, "chrom": chrom, "pos": row["pos"]})
        except ValueError:
            if validate_ref:
                raise
            continue
        items.append(item)
    return items


def write_jsonl(items: list, path: str) -> None:
    import json
    with open(path, "w") as f:
        for it in items:
            f.write(json.dumps(it) + "\n")


# ---------------------------------------------------------------------------
# ClinVar ingestion (the Clinvar_Coding / Clinvar_SNV_Non_SNV notebook tail,
# reference data/README.md): a ClinVar variant_summary-style TSV is mapped to
# the canonical variant rows, split into SNV (VEP-coding) vs non-SNV
# (structural) classes, with answers cleaned by the SAME functions the VEP
# dataset layer applies at load time (data/variant_effect.py cleaners), so
# curated labels and hub-dataset labels are byte-compatible.
# ---------------------------------------------------------------------------

_CLINVAR_COLS = {
    "chrom": ("Chromosome", "chrom"),
    "pos": ("PositionVCF", "Start", "pos"),
    "ref": ("ReferenceAlleleVCF", "ReferenceAllele", "ref"),
    "alt": ("AlternateAlleleVCF", "AlternateAllele", "alt"),
    "answer": ("ClinicalSignificance", "answer"),
    "gene": ("GeneSymbol", "gene"),
    "type": ("Type", "type"),
}

_SNV_TYPES = {"single nucleotide variant", "snv"}


def _clinvar_get(row: dict, field: str, default: str = "") -> str:
    for col in _CLINVAR_COLS[field]:
        if col in row and row[col] not in (None, ""):
            return str(row[col])
    return default


def read_clinvar_table(path: str, assembly: Optional[str] = None) -> list:
    """ClinVar variant_summary-style TSV -> canonical variant rows with a
    `variant_class` ('snv' | 'non_snv') per row.

    * column aliases: Chromosome/PositionVCF/ReferenceAlleleVCF/
      AlternateAlleleVCF/ClinicalSignificance/GeneSymbol/Type (falls back to
      the plain names of read_variant_table);
    * `assembly` filters on the Assembly column when present (ClinVar lists
      GRCh37+GRCh38 rows for the same allele);
    * class: `Type == single nucleotide variant` (or 1bp ref/alt) -> 'snv',
      everything else (Deletion/Duplication/Insertion/Indel/Microsatellite)
      -> 'non_snv';
    * ClinVar spells deleted/inserted alleles as '-' in some exports —
      normalized to empty here (apply_variant semantics).
    """
    import csv
    out = []
    with open(path) as f:
        first = f.readline()
        f.seek(0)
        delim = "\t" if "\t" in first else ","
        reader = csv.DictReader(
            (l for l in f if not l.startswith("##")), delimiter=delim)
        fieldnames = [c.lstrip("#") for c in (reader.fieldnames or ())]
        reader.fieldnames = fieldnames
        for row in reader:
            if assembly and row.get("Assembly") and row["Assembly"] != assembly:
                continue
            ref = _clinvar_get(row, "ref").replace("-", "").upper()
            alt = _clinvar_get(row, "alt").replace("-", "").upper()
            vtype = _clinvar_get(row, "type").strip().lower()
            is_snv = (vtype in _SNV_TYPES if vtype
                      else (len(ref) == 1 and len(alt) == 1))
            answer = _clinvar_get(row, "answer")
            if not answer:
                continue
            out.append({
                "chrom": _clinvar_get(row, "chrom"),
                "pos": _clinvar_get(row, "pos"),
                "ref": ref, "alt": alt, "answer": answer,
                "gene": _clinvar_get(row, "gene"),
                "reasoning": row.get("reasoning", ""),
                "variant_class": "snv" if is_snv else "non_snv",
            })
    return out


# ---------------------------------------------------------------------------
# eQTL / OMIM VEP tasks (reference data/VEP.ipynb tasks 2 & 3: builds
# `variant_effect_causal_eqtl` and `varient_effect_pathogenic_omim` —
# the hub config keeps the reference's 'varient' typo — from tables of
# pre-built ref/alt sequences, a bank of 50 question paraphrases formatted
# with chromosome [+ tissue], and per-row IDs 'Task{N}_{split}_{i}').
# The question bank here is generated compositionally (10 openings x 5
# framings) rather than copied; per-row template choice is seeded, where the
# notebook uses random.randrange(50).
# ---------------------------------------------------------------------------

_EQTL_OPENINGS = [
    "This variant is isolated from Chromosome {chrom} in {tissue} tissue.",
    "This variant originates from Chromosome {chrom} in {tissue} tissue.",
    "The following variant was found on Chromosome {chrom} in {tissue} tissue.",
    "Consider a variant located on Chromosome {chrom}, sampled from {tissue} tissue.",
    "A mutation on Chromosome {chrom} was identified in {tissue} tissue.",
    "Here is a variant from Chromosome {chrom}, observed in {tissue} tissue.",
    "The variant below lies on Chromosome {chrom} and comes from {tissue} tissue.",
    "This genetic alteration sits on Chromosome {chrom} in {tissue} tissue.",
    "An allele difference on Chromosome {chrom} was detected in {tissue} tissue.",
    "The sequenced variant maps to Chromosome {chrom} in {tissue} tissue.",
]
_EQTL_FRAMINGS = [
    "Does this variant change gene expression?",
    "Does it alter gene expression levels?",
    "Is gene expression affected by this variant?",
    "Will this variant cause a change in how genes are expressed?",
    "Is there a detectable effect on gene expression?",
]

_OMIM_OPENINGS = [
    "This variant is located on Chromosome {chrom}.",
    "The following variant lies on Chromosome {chrom}.",
    "Consider this variant from Chromosome {chrom}.",
    "A mutation was identified on Chromosome {chrom}.",
    "Here is a variant mapping to Chromosome {chrom}.",
    "The sequenced variant sits on Chromosome {chrom}.",
    "An allele difference was detected on Chromosome {chrom}.",
    "This genetic alteration is on Chromosome {chrom}.",
    "The variant below originates from Chromosome {chrom}.",
    "Chromosome {chrom} harbors this variant.",
]
_OMIM_FRAMINGS = [
    "Is it pathogenic or benign?",
    "Is this variant classified as benign or pathogenic?",
    "Would you consider it benign or pathogenic?",
    "What is its clinical impact — benign or pathogenic?",
    "How should it be labeled: pathogenic or benign?",
]


def question_bank(task: str) -> list:
    """50 question paraphrases for a VEP task ('eqtl' | 'omim'), with
    {chrom} (and {tissue} for eqtl) format fields — the local stand-in for
    the notebook's 50 GPT-generated question variants (VEP.ipynb)."""
    if task == "eqtl":
        return [f"{o} {f}" for o in _EQTL_OPENINGS for f in _EQTL_FRAMINGS]
    if task == "omim":
        return [f"{o} {f}" for o in _OMIM_OPENINGS for f in _OMIM_FRAMINGS]
    raise ValueError(f"no question bank for task {task!r}")


def _vep_sequences(row: dict, contigs: Optional[Dict[str, str]],
                   flank: int, validate_ref: bool):
    """(ref_seq, alt_seq) for a task row: taken directly from sequence
    columns when present (the hub datasets ship ref_forward_sequence /
    alt_forward_sequence pre-built), else windowed from the genome."""
    ref_seq = row.get("reference_sequence") or row.get("ref_forward_sequence")
    alt_seq = (row.get("variant_sequence") or row.get("alt_forward_sequence")
               or row.get("mutated_sequence"))
    if ref_seq and alt_seq:
        return ref_seq.upper(), alt_seq.upper()
    if contigs is None:
        raise ValueError("row has no sequence columns and no FASTA was given")
    chrom = row["chrom"]
    if chrom not in contigs:
        raise KeyError(f"contig {chrom!r} not in FASTA")
    variant = Variant(position=int(row["pos"]) - 1,
                      ref_allele=row["ref"].replace("-", ""),
                      alt_allele=row["alt"].replace("-", ""))
    window, offset = extract_window(contigs[chrom], variant.position, flank)
    alt_window = apply_variant(window, offset, variant, validate=validate_ref)
    return window.upper(), alt_window.upper()


def curate_eqtl(rows: list, split: str = "train",
                contigs: Optional[Dict[str, str]] = None, flank: int = 1000,
                seed: int = 0, validate_ref: bool = True) -> list:
    """Causal-eQTL task rows -> hub-schema records (VEP.ipynb task 2):
    {ID, question, answer, reference_sequence, variant_sequence} with
    'Task2_{split}_{i}' IDs and chromosome+tissue-templated questions.
    Rows need `tissue`, `chromosome` (or `chrom`) and `label` (or `answer`)
    plus either sequence columns or chrom/pos/ref/alt against `contigs`."""
    import random
    rng = random.Random(seed)
    bank = question_bank("eqtl")
    items = []
    for i, row in enumerate(rows):
        chrom = row.get("chromosome") or row.get("chrom", "")
        ref_seq, alt_seq = _vep_sequences(row, contigs, flank, validate_ref)
        items.append({
            "ID": f"Task2_{split}_{i}",
            "question": bank[rng.randrange(len(bank))].format(
                chrom=chrom, tissue=row.get("tissue", "")),
            "answer": str(row.get("label", row.get("answer", ""))),
            "reference_sequence": ref_seq,
            "variant_sequence": alt_seq,
        })
    return items


def curate_omim(rows: list, split: str = "test",
                contigs: Optional[Dict[str, str]] = None, flank: int = 1000,
                seed: int = 0, validate_ref: bool = True) -> list:
    """Pathogenic-OMIM task rows -> hub-schema records (VEP.ipynb task 3,
    test-only in the reference): 'Common' labels map to 'Benign'
    (task_3['label'].apply, VEP.ipynb) and questions are
    chromosome-templated pathogenic/benign paraphrases."""
    import random
    rng = random.Random(seed)
    bank = question_bank("omim")
    items = []
    for i, row in enumerate(rows):
        chrom = row.get("chromosome") or row.get("chrom", "")
        label = str(row.get("label", row.get("answer", "")))
        if label == "Common":
            label = "Benign"
        ref_seq, alt_seq = _vep_sequences(row, contigs, flank, validate_ref)
        items.append({
            "ID": f"Task3_{split}_{i}",
            "question": bank[rng.randrange(len(bank))].format(chrom=chrom),
            "answer": label,
            "reference_sequence": ref_seq,
            "variant_sequence": alt_seq,
        })
    return items


def read_task_table(path: str) -> list:
    """TSV/CSV with arbitrary VEP-task columns (sequence columns or
    chrom/pos/ref/alt; tissue/chromosome/label as available). Returns row
    dicts; no required-column check — the curators validate per task."""
    import csv
    with open(path) as f:
        first = f.readline()
        f.seek(0)
        delim = "\t" if "\t" in first else ","
        reader = csv.DictReader(
            (l for l in f if not l.startswith("#")), delimiter=delim)
        return list(reader)


def curate_clinvar(contigs: Dict[str, str], rows: list, task: str,
                   flank: int = 1000, validate_ref: bool = True) -> list:
    """ClinVar rows -> VEP training items for `task`
    ('variant_effect_coding' keeps SNV rows; 'variant_effect_non_snv' keeps
    the rest), windowed like curate_items and answer-cleaned with the task's
    dataset-layer cleaner (reference variant_effect.py:26-39 semantics)."""
    from bioreason_tpu_torch.data.variant_effect import (
        clean_variant_effect_example, clean_variant_effect_non_snv_example)
    want = "snv" if task == "variant_effect_coding" else "non_snv"
    if task not in ("variant_effect_coding", "variant_effect_non_snv"):
        raise ValueError(f"not a VEP task: {task}")
    clean = (clean_variant_effect_example if want == "snv"
             else clean_variant_effect_non_snv_example)
    kept = [r for r in rows if r.get("variant_class", "snv") == want]
    items = curate_items(contigs, kept, task=task, flank=flank,
                         validate_ref=validate_ref)
    return [clean(it) for it in items]
