"""Reasoning-trace generation for curated variant datasets (the port of
bioreason_tpu/data/traces.py).

The reference's KEGG curation notebook
(`BioReasoning_DataCuration_KEGG.ipynb`) sends one prompt per variant row
to the Anthropic API (message batches, temperature 0.2) and collects JSON
analyses ``{raw_data, question, answer, reasoning: {variant_id, hgvs,
reasoning_steps, labels}}`` into ``all_variant_analyses.json``; those
analyses become the KEGG SFT items (``question`` / ``answer`` /
``reasoning.reasoning_steps``: data/kegg.py:process_kegg_item).

Here the traces come LOCALLY, with no external API:

* ``backend="engine"``: the prompts go through the port's own
  `GenerationEngine` with any model (an SFT or GRPO checkpoint), on the
  card unless the caller builds the engine for the CPU; optionally with
  guided decoding pinning the output to the JSON skeleton. Stating the
  known answer in the prompt makes this the rationalization /
  distillation recipe: the model explains a curated fact rather than
  guessing it.
* ``backend="template"``: a deterministic synthesis of the reasoning
  steps from the structured variant fields (gene, network definition,
  disease, alleles), with no model at all.

Every analysis records which backend produced it. An engine reply that
does not parse as the analysis JSON is replaced by the template's
analysis, marked "template-fallback" (counted, never silent): that is the
reference tool's own semantics, not a fallback of the device path.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional, Sequence

__all__ = [
    "load_variant_tsv", "hgvs_g", "build_analysis_prompt",
    "template_analysis", "parse_analysis_json", "generate_analyses",
    "analysis_to_item", "combine_analyses",
]


# -- input parsing -------------------------------------------------------


def load_variant_tsv(path: str) -> List[Dict[str, str]]:
    """Header TSV -> row dicts; malformed rows (wrong column count) are
    skipped, like the notebook's loader. Typical KEGG-network columns:
    Var_ID, ENTRY, Chr, Start, RefAllele, AltAllele, Network Definition,
    Gene (JSON), Disease (JSON)."""
    rows: List[Dict[str, str]] = []
    with open(path, "r", encoding="utf-8") as f:
        header = f.readline().rstrip("\n").split("\t")
        for line in f:
            values = line.rstrip("\n").split("\t")
            if len(values) == len(header):
                rows.append(dict(zip(header, values)))
    return rows


def _json_or_raw(value: Optional[str]):
    """Gene/Disease columns hold either a JSON object or a bare string."""
    if not value:
        return {}
    if value.startswith("{"):
        try:
            return json.loads(value)
        except json.JSONDecodeError:
            return value
    return value


def gene_names(variant: Dict[str, str]) -> str:
    g = _json_or_raw(variant.get("Gene"))
    if isinstance(g, dict):
        names = [str(v).split(";")[0].strip() for v in g.values()]
        return ", ".join(n for n in names if n) or "Unknown"
    return str(g) or "Unknown"


def disease_name(variant: Dict[str, str]) -> str:
    d = _json_or_raw(variant.get("Disease"))
    if isinstance(d, dict):
        return next(iter(d), "Unknown")
    return str(d) or "Unknown"


def hgvs_g(chrom: str, pos, ref: str, alt: str) -> str:
    """Genomic HGVS: SNV `chrN:g.{pos}{ref}>{alt}`; deletions/insertions
    via del/ins forms (positions 1-based, like ClinVar)."""
    chrom = str(chrom)
    prefix = chrom if chrom.lower().startswith("chr") else f"chr{chrom}"
    pos = int(pos)
    ref, alt = (ref or "").upper(), (alt or "").upper()
    if len(ref) == 1 and len(alt) == 1:
        return f"{prefix}:g.{pos}{ref}>{alt}"
    if alt == "" or (len(ref) > len(alt) and ref.startswith(alt)):
        cut = len(alt)
        start, end = pos + cut, pos + len(ref) - 1
        span = f"{start}" if start == end else f"{start}_{end}"
        return f"{prefix}:g.{span}del"
    if ref == "" or (len(alt) > len(ref) and alt.startswith(ref)):
        ins = alt[len(ref):]
        return f"{prefix}:g.{pos + len(ref) - 1}_{pos + len(ref)}ins{ins}"
    return f"{prefix}:g.{pos}_{pos + len(ref) - 1}delins{alt}"


# -- prompting -----------------------------------------------------------


def build_analysis_prompt(variant: Dict[str, str],
                          known_answer: str = "") -> str:
    """One variant row -> the analysis prompt. Requests the same JSON
    fields the notebook's API prompt does (question / answer /
    reasoning_steps / labels); when `known_answer` is given it is stated
    as ground truth so the model rationalizes the curated label instead
    of predicting one."""
    gene = gene_names(variant)
    disease = disease_name(variant)
    hgvs = ""
    if variant.get("Chr") and variant.get("Start"):
        try:
            hgvs = hgvs_g(variant["Chr"], variant["Start"],
                          variant.get("RefAllele", ""),
                          variant.get("AltAllele", ""))
        except (ValueError, TypeError):
            hgvs = ""
    lines = [
        "Analyze this disease-associated genetic variant and produce a "
        "structured reasoning path from mutation to disease.",
        "",
        "Variant:",
        f"- id: {variant.get('Var_ID', 'Unknown')}",
        f"- gene: {variant.get('ENTRY', 'Unknown')} ({gene})",
        f"- location: chr{variant.get('Chr', '?')}:"
        f"{variant.get('Start', '?')} "
        f"{variant.get('RefAllele', '?')}>{variant.get('AltAllele', '?')}"
        + (f" ({hgvs})" if hgvs else ""),
        f"- pathway/network: {variant.get('Network Definition', 'Unknown')}",
        f"- associated disease: {disease}",
    ]
    if known_answer:
        lines.append(f"- established effect (ground truth): {known_answer}")
    lines += [
        "",
        "Reply with ONE JSON object and nothing else, shaped as:",
        '{"question": "...", "answer": "...", '
        '"reasoning_steps": ["Step 1: ...", "..."]}',
        "The question asks what biological effect the variant has and "
        "what disease it may contribute to; the answer is 2-3 sentences; "
        "reasoning_steps is 8-12 ordered steps tracing mutation -> "
        "protein -> pathway -> cell -> disease.",
    ]
    return "\n".join(lines)


# -- template backend ----------------------------------------------------


def template_analysis(variant: Dict[str, str],
                      known_answer: str = "") -> Dict[str, Any]:
    """Deterministic analysis from the structured fields alone: the
    zero-model backend, and the analysis of an engine reply that does not
    parse.
    Produces the full notebook schema with 9 reasoning steps."""
    gene_entry = variant.get("ENTRY", "Unknown")
    genes = gene_names(variant)
    disease = disease_name(variant)
    network = variant.get("Network Definition", "its pathway")
    ref = variant.get("RefAllele", "?")
    alt = variant.get("AltAllele", "?")
    chrom, pos = variant.get("Chr", "?"), variant.get("Start", "?")
    var_id = variant.get("Var_ID", "variant")
    try:
        hgvs = hgvs_g(chrom, pos, ref, alt)
    except (ValueError, TypeError):
        hgvs = f"chr{chrom}:g.{pos}{ref}>{alt}"

    question = (f"What is the biological effect of the {genes} mutation "
                f"{var_id} ({ref}>{alt} at position {pos} on chromosome "
                f"{chrom}) and what disease might it contribute to?")
    answer = known_answer or (
        f"The {ref}>{alt} substitution in {genes} perturbs {network}, "
        f"compromising the gene's normal function in that pathway. "
        f"Through this mechanism the variant contributes to {disease}.")
    steps = [
        f"Step 1: The variant {var_id} substitutes {ref} with {alt} at "
        f"position {pos} on chromosome {chrom} ({hgvs}).",
        f"Step 2: This position lies in {gene_entry} ({genes}), so the "
        f"change alters the gene's coding or regulatory sequence.",
        f"Step 3: The altered sequence changes the encoded product or "
        f"its expression level.",
        f"Step 4: {genes} participates in {network}.",
        f"Step 5: The mutant product can no longer fulfil its normal "
        f"role at this point of the network.",
        f"Step 6: Signal flow through the network is disrupted "
        f"downstream of {genes}.",
        f"Step 7: Cells depending on this pathway mis-regulate the "
        f"processes it controls (growth, differentiation, repair or "
        f"signalling).",
        f"Step 8: Accumulated cellular dysfunction manifests at the "
        f"tissue level.",
        f"Step 9: This mechanism links {var_id} to {disease}.",
    ]
    return {
        "raw_data": dict(variant),
        "question": question,
        "answer": answer,
        "reasoning": {
            "variant_id": var_id,
            "hgvs": hgvs,
            "reasoning_steps": steps,
            "labels": {"pathways": [network], "diseases": [disease],
                       "genes": [g.strip() for g in genes.split(",")]},
        },
        "backend": "template",
    }


# -- engine backend ------------------------------------------------------

_JSON_RE = re.compile(r"\{.*\}", re.DOTALL)


def parse_analysis_json(text: str, variant: Dict[str, str]
                        ) -> Optional[Dict[str, Any]]:
    """Extract the analysis object from model output: outermost {...}
    span, tolerant of surrounding prose/markdown fences. Returns None
    when there is no parseable object with the required fields."""
    m = _JSON_RE.search(text)
    if not m:
        return None
    try:
        obj = json.loads(m.group(0))
    except json.JSONDecodeError:
        return None
    if not isinstance(obj, dict):
        return None
    steps = obj.get("reasoning_steps")
    if steps is None and isinstance(obj.get("reasoning"), dict):
        steps = obj["reasoning"].get("reasoning_steps")
    if (not isinstance(obj.get("question"), str)
            or not isinstance(obj.get("answer"), str)
            or not isinstance(steps, list) or not steps):
        return None
    var_id = variant.get("Var_ID", "variant")
    try:
        hgvs = hgvs_g(variant.get("Chr", "?"), variant.get("Start", 0),
                      variant.get("RefAllele", ""),
                      variant.get("AltAllele", ""))
    except (ValueError, TypeError):
        hgvs = ""
    return {
        "raw_data": dict(variant),
        "question": obj["question"],
        "answer": obj["answer"],
        "reasoning": {
            "variant_id": var_id,
            "hgvs": obj.get("hgvs", hgvs),
            "reasoning_steps": [str(s) for s in steps],
            "labels": obj.get("labels", {}),
        },
        "backend": "engine",
    }


def guided_regex_for_analysis(max_steps: int = 12) -> str:
    """Regex skeleton for the analysis JSON (guided decoding): quoted
    strings without embedded quotes/braces, 1..max_steps steps."""
    s = r'"[^"{}\\]*"'
    step = s
    steps = f"{step}(, {step}){{0,{max_steps - 1}}}"
    return (r'\{"question": ' + s + r', "answer": ' + s
            + r', "reasoning_steps": \[' + steps + r'\]\}')


def generate_analyses(variants: Sequence[Dict[str, str]],
                      backend: str = "template",
                      known_answers: Optional[Sequence[str]] = None,
                      engine=None, model=None, processor=None,
                      sampling=None, max_new_tokens: int = 512,
                      batch_size: int = 8, guided=None, generator=None,
                      ) -> List[Dict[str, Any]]:
    """Analyses for `variants`. backend='template' is pure Python;
    backend='engine' renders each prompt through the chat template,
    batches them through `engine` (generate.engine.GenerationEngine) with
    `model`, sampling from `generator`, and parses the JSON replies: rows
    that do not parse take the template's analysis (analysis["backend"]
    marks which path ran)."""
    answers = list(known_answers) if known_answers is not None else [
        ""] * len(variants)
    assert len(answers) == len(variants)
    if backend == "template":
        return [template_analysis(v, a) for v, a in zip(variants, answers)]
    if backend != "engine":
        raise ValueError(f"unknown backend {backend!r}")
    if engine is None or model is None or processor is None:
        raise ValueError("backend='engine' needs engine, model, processor")

    from bioreason_tpu_torch.config import SamplingConfig
    from bioreason_tpu_torch.data.chat_template import apply_chat_template
    sampling = sampling or SamplingConfig(temperature=0.2, top_k=50,
                                          top_p=0.95)
    out: List[Dict[str, Any]] = []
    for start in range(0, len(variants), batch_size):
        chunk = list(variants[start:start + batch_size])
        chunk_ans = answers[start:start + batch_size]
        prompts = [apply_chat_template({
            "prompt": [{"role": "user", "content": [
                {"type": "text",
                 "text": build_analysis_prompt(v, a)}]}],
        })["prompt"] for v, a in zip(chunk, chunk_ans)]
        enc = processor(text=prompts, batch_dna_sequences=[[] for _ in chunk],
                        padding_side="left")
        ids, mask = engine.generate(
            model, enc.input_ids, enc.attention_mask,
            enc.dna_input_ids, enc.dna_attention_mask,
            sampling=sampling, max_new_tokens=max_new_tokens,
            generator=generator, guided=guided)
        texts = processor.text_tokenizer.batch_decode(
            [row[m.astype(bool)] for row, m in zip(ids, mask)],
            skip_special_tokens=True)
        for v, a, txt in zip(chunk, chunk_ans, texts):
            parsed = parse_analysis_json(txt, v)
            out.append(parsed if parsed is not None
                       else {**template_analysis(v, a),
                             "backend": "template-fallback"})
    return out


# -- output --------------------------------------------------------------


def analysis_to_item(analysis: Dict[str, Any]) -> Dict[str, Any]:
    """Analysis -> KEGG-dataset item (question/answer/reasoning dict the
    SFT formatters consume; data/kegg.py:process_kegg_item)."""
    return {
        "question": analysis["question"],
        "answer": analysis["answer"],
        "reasoning": {"reasoning_steps":
                      analysis["reasoning"]["reasoning_steps"]},
    }


def combine_analyses(analyses: Sequence[Dict[str, Any]], path: str) -> None:
    """`all_variant_analyses.json` equivalent: one combined JSON list."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump(list(analyses), f, indent=1)
