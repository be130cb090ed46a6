"""The port's curation tools (`data/curation.py`, `data/retrieval.py`,
`cli/curate.py`: its own copies, which import nothing of the JAX package)
against the JAX package's: the cases of tests/test_loaders.py's curation
classes and of tests/test_retrieval.py run on the port, and every
deterministic output (windows, items, question banks, parsed KEGG and
Ensembl records, merged rows, the CLI's JSONL) held equal to JAX's on the
same inputs. No network: every transport is canned or a cache directory."""

import json

import numpy as np
import pytest

from bioreason_tpu.cli import curate as JCLI
from bioreason_tpu.data import curation as JCur
from bioreason_tpu.data import retrieval as JRet
from bioreason_tpu_torch.cli import curate as TCLI
from bioreason_tpu_torch.data import curation as TCur
from bioreason_tpu_torch.data import retrieval as TRet
from bioreason_tpu_torch.data.loaders import load_local_dataset
import test_loaders
from test_retrieval import (NETWORK_N1, NETWORK_N2, PAGES, VAR_3845V1, VAR_UNRESOLVED)


def test_window_variant_and_item_match_jax():
    """TestCuration's cases on the port (SNV, deletion, insertion, the
    reference check, the item), each result equal to JAX's."""
    seq = "A" * 50 + "C" + "G" * 50
    win, off = TCur.extract_window(seq, 50, flank=10)
    assert (win, off) == JCur.extract_window(seq, 50, flank=10)
    assert len(win) == 20 and win[off] == "C"
    for w, o, (pos, ref, alt) in ((win, off, (50, "C", "T")), ("ACGTACGT", 2, (0, "GT", "")),
                                  ("ACGTACGT", 2, (0, "", "TTT"))):
        got = TCur.apply_variant(w, o, TCur.Variant(pos, ref, alt))
        assert got == JCur.apply_variant(w, o, JCur.Variant(pos, ref, alt))
    assert TCur.apply_variant("ACGTACGT", 2, TCur.Variant(0, "GT", "")) == "ACACGT"
    with pytest.raises(ValueError, match="mismatch"):
        TCur.apply_variant("ACGTACGT", 2, TCur.Variant(0, "AA", "T"))
    seq = "ACGT" * 100
    item = TCur.build_variant_item(seq, TCur.Variant(200, "A", "G"), "what effect?",
                                   "Pathogenic", flank=16, metadata={"gene": "G"})
    assert item == JCur.build_variant_item(seq, JCur.Variant(200, "A", "G"), "what effect?",
                                           "Pathogenic", flank=16, metadata={"gene": "G"})
    assert item["answer"] == "pathogenic" and len(item["reference_sequence"]) == 32


@pytest.mark.parametrize("task", ["kegg", "variant_effect_coding", "variant_effect_non_snv"])
def test_curate_cli_matches_jax(tmp_path, task):
    """TestCurationPipeline's round trip through the port's CLI: its JSONL
    equals the JAX CLI's for every task, and loads into items whose windows
    come from the genome."""
    fasta, tsv, seq = test_loaders.TestCurationPipeline()._write_inputs(tmp_path)
    outs = {}
    for cli, tag in ((TCLI, "t"), (JCLI, "j")):
        out = tmp_path / f"{tag}.jsonl"
        cli.main(["--fasta", str(fasta), "--variants", str(tsv), "--task", task,
                  "--flank", "30", "--out", str(out)])
        outs[tag] = out.read_text()
    assert outs["t"] == outs["j"]
    items = load_local_dataset(str(tmp_path / "t.jsonl"))
    assert len(items) == 3 and items[0]["answer"] == "pathogenic"
    assert items[0]["reference_sequence"] in seq.upper()
    assert "BRCA1" in items[0]["question"]


def test_ref_allele_validation_matches_jax(tmp_path):
    fasta, tsv, _ = test_loaders.TestCurationPipeline()._write_inputs(tmp_path)
    contigs = TCur.read_fasta(str(fasta))
    assert contigs == JCur.read_fasta(str(fasta))
    rows = TCur.read_variant_table(str(tsv))
    assert rows == JCur.read_variant_table(str(tsv))
    rows[1]["ref"] = "N"
    with pytest.raises(ValueError, match="reference allele mismatch"):
        TCur.curate_items(contigs, rows, task="kegg", flank=30)
    kept = TCur.curate_items(contigs, rows, task="kegg", flank=30, validate_ref=False)
    assert len(kept) == 2
    assert kept == JCur.curate_items(contigs, rows, task="kegg", flank=30, validate_ref=False)


def test_eqtl_and_omim_match_jax(tmp_path):
    """TestEqtlOmimCuration's cases: the question banks, the eQTL table
    through the CLI, OMIM windows from a genome, seeded paraphrases; every
    output equal to JAX's."""
    for task in ("eqtl", "omim"):
        assert TCur.question_bank(task) == JCur.question_bank(task)
        assert len(set(TCur.question_bank(task))) == 50
    p = tmp_path / "eqtl.tsv"
    p.write_text("chromosome\ttissue\tlabel\tref_forward_sequence\talt_forward_sequence\n"
                 "7\tLiver\tYes\tacgtacgt\tacctacgt\n"
                 "X\tBrain - Cortex\tNo\tggggcccc\tggtgcccc\n")
    for cli, tag in ((TCLI, "t"), (JCLI, "j")):
        cli.main(["--variants", str(p), "--task", "eqtl", "--out", str(tmp_path / f"{tag}.jsonl")])
    assert (tmp_path / "t.jsonl").read_text() == (tmp_path / "j.jsonl").read_text()
    items = load_local_dataset(str(tmp_path / "t.jsonl"))
    assert [it["ID"] for it in items] == ["Task2_train_0", "Task2_train_1"]
    assert items[0]["reference_sequence"] == "ACGTACGT"
    q = tmp_path / "omim.csv"
    genome = "ACGT" * 10
    q.write_text("chrom,pos,ref,alt,label\nchr1,3,G,T,Pathogenic\nchr1,13,A,C,Common\n")
    rows = TCur.read_task_table(str(q))
    assert rows == JCur.read_task_table(str(q))
    omim = TCur.curate_omim(rows, contigs={"chr1": genome}, flank=4)
    assert omim == JCur.curate_omim(rows, contigs={"chr1": genome}, flank=4)
    assert [it["answer"] for it in omim] == ["Pathogenic", "Benign"]
    rows = [{"chromosome": "1", "tissue": "Lung", "label": "Yes",
             "reference_sequence": "AAAA", "variant_sequence": "AACA"} for _ in range(8)]
    for seed in (3, 4):
        assert TCur.curate_eqtl(rows, seed=seed) == JCur.curate_eqtl(rows, seed=seed)
    assert ([x["question"] for x in TCur.curate_eqtl(rows, seed=3)]
            != [x["question"] for x in TCur.curate_eqtl(rows, seed=4)])


def test_clinvar_curation_matches_jax(tmp_path):
    """TestClinVarCuration's cases: the assembly filter, the SNV / non-SNV
    split, the cleaned answers, equal to JAX's; a reference mismatch raises."""
    path = test_loaders.TestClinVarCuration()._tsv(tmp_path)
    rows = TCur.read_clinvar_table(path, assembly="GRCh38")
    assert rows == JCur.read_clinvar_table(path, assembly="GRCh38") and len(rows) == 2
    contigs = {"chr1": test_loaders.TestClinVarCuration.GENOME}
    for task in ("variant_effect_coding", "variant_effect_non_snv"):
        got = TCur.curate_clinvar(contigs, rows, task, flank=6)
        assert got == JCur.curate_clinvar(contigs, rows, task, flank=6) and len(got) == 1
    assert TCur.curate_clinvar(contigs, rows, "variant_effect_coding", flank=6)[0]["answer"] \
        == "pathogenic"
    bad = tmp_path / "bad.tsv"
    bad.write_text("Chromosome\tPositionVCF\tReferenceAlleleVCF\tAlternateAlleleVCF\t"
                   "ClinicalSignificance\tType\nchr1\t9\tG\tT\tBenign\tsingle nucleotide variant\n")
    with pytest.raises(ValueError, match="reference allele mismatch"):
        TCur.curate_clinvar(contigs, TCur.read_clinvar_table(str(bad)),
                            "variant_effect_coding", flank=6)


# -- retrieval ---------------------------------------------------------------------

@pytest.mark.parametrize("text", [NETWORK_N1, NETWORK_N2, VAR_3845V1, VAR_UNRESOLVED])
def test_kegg_parsers_match_jax(text):
    """tests/test_retrieval.py's parsing cases: flat fields with
    continuations, the network entry's keyed maps, the gene-variant tokens
    and the variant cross-references, equal to JAX's."""
    for fn in ("parse_kegg_flat", "parse_network_entry", "gene_variant_tokens",
               "extract_variant_refs"):
        assert getattr(TRet, fn)(text) == getattr(JRet, fn)(text), fn
    flat = TRet.parse_kegg_flat(NETWORK_N1)
    assert flat["PATHWAY"] == "hsa05200  Pathways in cancer| hsa04010  MAPK signaling pathway"
    assert TRet.gene_variant_tokens(NETWORK_N1) == ["3845v1"]
    assert TRet.extract_variant_refs(VAR_3845V1) == [("dbSNP", "rs121913529"),
                                                     ("ClinVar", "12582")]


def test_clients_match_jax():
    """The KEGG and Ensembl clients on the canned pages: lists, links,
    entries and the GRCh38 mapping (0-based start), equal to JAX's; a
    missing assembly raises."""
    t, j = TRet.canned_transport(PAGES), JRet.canned_transport(PAGES)
    tk, jk = TRet.KeggClient(t), JRet.KeggClient(j)
    for args in (("list", "network"), ("list", "disease"), ("link", "pathway", "network"),
                 ("get", "hsa_var:3845v1")):
        assert getattr(tk, args[0])(*args[1:]) == getattr(jk, args[0])(*args[1:])
    var = TRet.EnsemblVariationClient(t).variation("rs121913529")
    assert var == JRet.EnsemblVariationClient(j).variation("rs121913529")
    assert (var["chrom"], var["start"], var["ref"], var["alts"]) == ("12", 3, "C", ["A", "T"])
    with pytest.raises(ValueError):
        TRet.EnsemblVariationClient(t, assembly="T2T-CHM13").variation("rs121913529")


def test_dir_cache_reads_through_and_replays(tmp_path):
    """TestDirCache on the port: one inner fetch, then the cache; an offline
    transport replays it and raises KeyError on a miss; the cache keys equal
    JAX's (so one cache directory serves both packages)."""
    calls = []

    def inner(url):
        calls.append(url)
        return PAGES[url]
    cache = TRet.DirCacheTransport(str(tmp_path), inner=inner)
    url = f"{TRet.KEGG_REST}/get/N00001"
    assert cache(url) == NETWORK_N1 and cache(url) == NETWORK_N1 and calls == [url]
    offline = TRet.DirCacheTransport(str(tmp_path))
    assert offline(url) == NETWORK_N1
    with pytest.raises(KeyError):
        offline(f"{TRet.KEGG_REST}/get/N99999")
    for u in PAGES:
        key = TRet.cache_key(u)
        assert key == JRet.cache_key(u) and "/" not in key and "?" not in key


@pytest.mark.parametrize("networks,rename", [(None, False), (["N00001"], False),
                                             (["N00001"], True)])
def test_pipeline_rows_match_jax(networks, rename):
    """`retrieve_network_variant_rows` on the canned pages (all networks,
    one, and one whose only variant resolves nowhere: a placeholder row
    naming the unresolved refs): the rows equal JAX's, and the resolved
    ones window through `curate_items` as JAX's do."""
    pages = dict(PAGES)
    if rename:
        pages[f"{TRet.KEGG_REST}/get/N00001"] = NETWORK_N1.replace("3845v1", "7157v9")
    rows = {}
    for mod in (TRet, JRet):
        t = mod.canned_transport(pages)
        rows[mod] = mod.retrieve_network_variant_rows(mod.KeggClient(t),
                                                      mod.EnsemblVariationClient(t),
                                                      network_ids=networks)
    got = rows[TRet]
    assert got == rows[JRet]
    if rename:
        assert len(got) == 1 and got[0]["chrom"] == ""
        assert got[0]["unresolved_refs"] == ["dbVar:nsv123456"]
        return
    resolved = [r for r in got if r["chrom"]]
    assert len(resolved) == 2 and {r["alt"] for r in resolved} == {"A", "T"}
    assert resolved[0]["pos"] == 4 and resolved[0]["answer"] == "Gastric cancer; Oral cancer"
    items = TCur.curate_items({"12": "AAACGGGTTT"}, resolved, task="kegg", flank=3)
    assert items == JCur.curate_items({"12": "AAACGGGTTT"}, resolved, task="kegg", flank=3)
    assert {it["variant_sequence"] for it in items} == {"AAAAGG", "AAATGG"}


def test_curate_cli_kegg_api_cache_mode_matches_jax(tmp_path):
    """TestCurateCLI on the port: the KEGG retrieval mode replayed from a
    cache directory writes the JAX CLI's JSONL."""
    cache_dir = tmp_path / "cache"
    cache_dir.mkdir()
    for url, body in PAGES.items():
        (cache_dir / TRet.cache_key(url)).write_text(body)
    fasta = tmp_path / "genome.fa"
    fasta.write_text(">12\nAAACGGGTTT\n")
    for cli, tag in ((TCLI, "t"), (JCLI, "j")):
        cli.main(["--fasta", str(fasta), "--kegg_api_cache", str(cache_dir), "--flank", "3",
                  "--out", str(tmp_path / f"{tag}.jsonl")])
    text = (tmp_path / "t.jsonl").read_text()
    assert text == (tmp_path / "j.jsonl").read_text()
    items = [json.loads(line) for line in text.splitlines()]
    assert len(items) == 2 and all("reference_sequence" in it for it in items)
    assert np.all([len(it["reference_sequence"]) == 6 for it in items])
