"""API-retrieval front ends for the curation pipeline, offline-first (the
port's own copy of bioreason_tpu/data/retrieval.py, which it does not import).

The reference's KEGG curation notebook drives three remote services before
any sequence work happens (data/KEGG_Data_1.ipynb):

  * KEGG REST   — `kegg_pull rest list network|disease` (cells 2/7/27),
                  `kegg_pull rest link network pathway|disease` (cells 11/16),
                  `kegg_pull pull database network` + `pull entry-ids
                  hsa_var:...` (cells 28/46): flat-file entries.
  * Ensembl REST — `GET rest.ensembl.org/variation/human/{id}` JSON for
                  dbSNP/COSM ids (cell 127) -> chrom/start/allele_string.
  * The windows step then validates ref alleles against the genome and emits
    ±1000 nt (reference, variant) pairs (cells 240/242) — implemented in
    `data/curation.py`.

This module is the local equivalent of those front ends: the same pipeline
steps (list -> pull -> filter variant networks -> parse entries -> resolve
variant coordinates -> merged rows) over an injectable transport, so the
whole flow runs offline from a cache directory (the environment has no
egress) and becomes live retrieval by swapping in `url_transport` where
networking exists. `retrieve_network_variant_rows` returns rows shaped for
`curation.curate_items` / `build_variant_item`.

Transports are `callable(url: str) -> str`. `DirCacheTransport` is a
read-through cache keyed by a sanitized URL tail; `canned_transport` serves
tests from a dict.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

Transport = Callable[[str], str]

KEGG_REST = "https://rest.kegg.jp"
ENSEMBL_REST = "https://rest.ensembl.org"

# VARIATION cross-reference sources the notebook splits on (cell 58)
VARIANT_SOURCES = ("OmimVar", "ClinVar", "dbSNP", "COSM", "dbVar", "COSF")


# --------------------------------------------------------------------------
# transports
# --------------------------------------------------------------------------

def url_transport(timeout: float = 30.0) -> Transport:
    """Live HTTP transport (urllib). Unused in this environment (no egress);
    the seam the notebooks' curl/kegg_pull calls map onto."""
    def fetch(url: str) -> str:
        from urllib.request import urlopen  # deferred: offline-first
        with urlopen(url, timeout=timeout) as resp:  # noqa: S310
            return resp.read().decode("utf-8")
    return fetch


def cache_key(url: str) -> str:
    """Stable filesystem name for a URL (scheme/host stripped, path kept)."""
    tail = re.sub(r"^https?://", "", url)
    return re.sub(r"[^A-Za-z0-9._-]+", "_", tail)


class DirCacheTransport:
    """Read-through cache: serve `cache_dir/<key>` if present, else fetch via
    `inner` and persist. With `inner=None` it is a pure offline replay of a
    previously populated cache (raises KeyError on a miss)."""

    def __init__(self, cache_dir: str, inner: Optional[Transport] = None):
        self.cache_dir = cache_dir
        self.inner = inner
        os.makedirs(cache_dir, exist_ok=True)

    def __call__(self, url: str) -> str:
        path = os.path.join(self.cache_dir, cache_key(url))
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                return f.read()
        if self.inner is None:
            raise KeyError(f"offline cache miss for {url} "
                           f"(expected {path})")
        text = self.inner(url)
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
        return text


def canned_transport(pages: Dict[str, str]) -> Transport:
    """Test transport serving an in-memory {url: body} dict."""
    def fetch(url: str) -> str:
        if url not in pages:
            raise KeyError(f"no canned page for {url}")
        return pages[url]
    return fetch


# --------------------------------------------------------------------------
# KEGG flat-file parsing
# --------------------------------------------------------------------------

def parse_kegg_flat(text: str) -> Dict[str, str]:
    """KEGG flat entry -> {FIELD: joined value}. Continuation lines (leading
    whitespace) belong to the last field; multi-line values join with '| '
    exactly like the notebook's get_multiline_values (cell 209)."""
    fields: Dict[str, List[str]] = {}
    current: Optional[str] = None
    for line in text.splitlines():
        if line.strip() == "///" or not line.strip():
            continue
        if line[:1].isspace():
            if current is not None:
                fields[current].append(line.strip())
            continue
        parts = line.split(None, 1)
        current = parts[0]
        value = parts[1].strip() if len(parts) > 1 else ""
        fields.setdefault(current, [])
        if value:
            fields[current].append(value)
    return {k: "| ".join(v) for k, v in fields.items()}


def _keyed_map(joined: str) -> Dict[str, str]:
    """'hsa05200  Pathways in cancer| N00002  BCR-ABL ...' -> {id: name}
    (the notebook's extract_data, cell 213)."""
    out: Dict[str, str] = {}
    for part in joined.split("|"):
        tokens = part.strip().split()
        if len(tokens) >= 2:
            out[tokens[0]] = " ".join(tokens[1:])
        elif len(tokens) == 1:
            out[tokens[0]] = ""
    return out


def parse_network_entry(text: str) -> Dict[str, Any]:
    """KEGG network flat entry -> the notebook's network_info row (cell 209:
    Entry/Name/Definition/Expanded + keyed Pathway/Class/Disease/Gene)."""
    flat = parse_kegg_flat(text)
    entry = flat.get("ENTRY", "").split()[0] if flat.get("ENTRY") else ""
    return {
        "entry": entry,
        "name": flat.get("NAME", ""),
        "definition": flat.get("DEFINITION", ""),
        "expanded": flat.get("EXPANDED", ""),
        "pathway": _keyed_map(flat["PATHWAY"]) if "PATHWAY" in flat else {},
        "class": _keyed_map(flat["CLASS"]) if "CLASS" in flat else {},
        "disease": _keyed_map(flat["DISEASE"]) if "DISEASE" in flat else {},
        "gene": _keyed_map(flat["GENE"]) if "GENE" in flat else {},
    }


_GENE_VARIANT_RE = re.compile(r"\b(\d+v\d+)\b")


def gene_variant_tokens(network_text: str) -> List[str]:
    """All '<gene>v<n>' variant-element tokens in a network entry — the
    notebook's `grep -oE "[0-9]+v[0-9]+"` (cell 38), deduplicated in order."""
    seen: Dict[str, None] = {}
    for m in _GENE_VARIANT_RE.finditer(network_text):
        seen.setdefault(m.group(1))
    return list(seen)


def extract_variant_refs(variant_text: str) -> List[Tuple[str, str]]:
    """hsa_var flat entry -> [(source, id)] cross-references, recognizing the
    six sources the notebook splits parsed_variants.tsv on (cell 58)."""
    refs: List[Tuple[str, str]] = []
    pattern = re.compile(
        r"\b(%s)\s*:\s*([A-Za-z0-9_.-]+)" % "|".join(VARIANT_SOURCES))
    for m in pattern.finditer(variant_text):
        refs.append((m.group(1), m.group(2)))
    return refs


# --------------------------------------------------------------------------
# clients
# --------------------------------------------------------------------------

class KeggClient:
    """KEGG REST front end (list / link / get), one entry per flat block."""

    def __init__(self, transport: Transport, base: str = KEGG_REST):
        self.transport = transport
        self.base = base

    def list(self, db: str) -> List[Tuple[str, str]]:
        """`/list/{db}` -> [(id, description)] (cells 2/27)."""
        rows = []
        for line in self.transport(f"{self.base}/list/{db}").splitlines():
            if not line.strip():
                continue
            parts = line.split("\t", 1)
            rows.append((parts[0].strip(),
                         parts[1].strip() if len(parts) > 1 else ""))
        return rows

    def link(self, target: str, source: str) -> List[Tuple[str, str]]:
        """`/link/{target}/{source}` -> [(source_id, target_id)]
        (cells 11/16: network->pathway / network->disease maps)."""
        rows = []
        url = f"{self.base}/link/{target}/{source}"
        for line in self.transport(url).splitlines():
            if not line.strip():
                continue
            parts = line.split("\t")
            if len(parts) >= 2:
                rows.append((parts[0].strip(), parts[1].strip()))
        return rows

    def get(self, entry_id: str) -> str:
        """`/get/{id}` -> raw flat-file text (kegg_pull pull, cells 28/46)."""
        return self.transport(f"{self.base}/get/{entry_id}")


class EnsemblVariationClient:
    """Ensembl REST variation front end (cell 127)."""

    def __init__(self, transport: Transport, base: str = ENSEMBL_REST,
                 assembly: str = "GRCh38"):
        self.transport = transport
        self.base = base
        self.assembly = assembly

    def variation(self, variant_id: str) -> Dict[str, Any]:
        """`/variation/human/{id}` JSON -> {id, chrom, start(0-based), ref,
        alts, most_severe_consequence}. Picks the first mapping on the
        configured assembly (the notebook uses the JSON's primary mapping).
        Ensembl `start` is 1-based inclusive; converted to the 0-based
        coordinates `curation.Variant` uses."""
        url = (f"{self.base}/variation/human/{variant_id}"
               f"?content-type=application/json")
        doc = json.loads(self.transport(url))
        mapping = None
        for m in doc.get("mappings", []):
            if m.get("assembly_name", self.assembly) == self.assembly:
                mapping = m
                break
        if mapping is None:
            raise ValueError(f"{variant_id}: no {self.assembly} mapping")
        alleles = str(mapping.get("allele_string", "")).split("/")
        ref = alleles[0] if alleles else ""
        alts = [a for a in alleles[1:] if a]
        return {
            "id": doc.get("name", variant_id),
            "chrom": str(mapping.get("seq_region_name", "")),
            "start": int(mapping.get("start", 1)) - 1,
            "ref": "" if ref == "-" else ref,
            "alts": ["" if a == "-" else a for a in alts],
            "most_severe_consequence": doc.get("most_severe_consequence", ""),
        }


# --------------------------------------------------------------------------
# pipeline: networks -> variant refs -> coordinates -> curation rows
# --------------------------------------------------------------------------

def retrieve_network_variant_rows(
        kegg: KeggClient, ensembl: EnsemblVariationClient,
        network_ids: Optional[Sequence[str]] = None,
        organism_prefix: str = "hsa_var",
        skip_errors: bool = True) -> List[Dict[str, Any]]:
    """The KEGG_Data_1 retrieval pipeline as one call: list (or accept)
    network ids -> pull entries -> keep networks containing variant elements
    -> pull their hsa_var entries -> resolve dbSNP/COSM refs through Ensembl
    -> rows merging network metadata with variant coordinates.

    Rows carry the `read_variant_table` schema (chrom/pos/ref/alt/answer +
    gene/reasoning metadata) with pos 1-based, so
    `curation.curate_items(contigs, rows, task='kegg')` completes the
    notebook's windows step (cells 240/242). OmimVar/ClinVar/dbVar/COSF refs
    need their own databases (edirect / COSMIC TSVs, cells 59/130) and are
    surfaced in each row's 'unresolved_refs' instead of silently dropped."""
    if network_ids is None:
        network_ids = [nid for nid, _ in kegg.list("network")]
    rows: List[Dict[str, Any]] = []
    for nid in network_ids:
        try:
            net_text = kegg.get(nid)
        except Exception:
            if skip_errors:
                continue
            raise
        tokens = gene_variant_tokens(net_text)
        if not tokens:
            continue
        net = parse_network_entry(net_text)
        diseases = "; ".join(net["disease"].values()) or "unknown disease"
        pathways = "; ".join(net["pathway"].values())
        for tok in tokens:
            try:
                var_text = kegg.get(f"{organism_prefix}:{tok}")
            except Exception:
                if skip_errors:
                    continue
                raise
            refs = extract_variant_refs(var_text)
            resolved = False
            unresolved = []
            elem_rows: List[Dict[str, Any]] = []
            for source, ref_id in refs:
                if source not in ("dbSNP", "COSM"):
                    unresolved.append(f"{source}:{ref_id}")
                    continue
                try:
                    var = ensembl.variation(ref_id)
                except Exception:
                    if skip_errors:
                        unresolved.append(f"{source}:{ref_id}")
                        continue
                    raise
                for alt in var["alts"] or [""]:
                    elem_rows.append({
                        "chrom": var["chrom"],
                        "pos": var["start"] + 1,        # 1-based table schema
                        "ref": var["ref"],
                        "alt": alt,
                        "answer": diseases,
                        "gene": " ".join(net["gene"]) or tok.split("v")[0],
                        "reasoning": "",
                        "network": net["entry"],
                        "network_name": net["name"],
                        "pathways": pathways,
                        "source": source,
                        "source_id": var["id"],
                        "consequence": var["most_severe_consequence"],
                        "unresolved_refs": [],
                    })
                    resolved = True
            if not resolved and refs:
                elem_rows.append({
                    "chrom": "", "pos": 0, "ref": "", "alt": "",
                    "answer": diseases, "gene": tok.split("v")[0],
                    "reasoning": "", "network": net["entry"],
                    "network_name": net["name"], "pathways": pathways,
                    "source": "", "source_id": tok,
                    "consequence": "", "unresolved_refs": [],
                })
            # surface every non-resolvable ref on EVERY row of the element
            # (resolved rows included) — not just the no-resolution fallback
            for row in elem_rows:
                row["unresolved_refs"] = list(unresolved)
            rows.extend(elem_rows)
    return rows
