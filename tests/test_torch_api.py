"""The port's user API (`models/api.py`: `DnaLLM`, `DNAClassifier`) against
the JAX package's: the cases of tests/test_api.py run on the port, then the
same weights (carried over by `from_jax_params`) and inputs through both
wrappers: logits, greedy text, predictions. Tiny configs in fp32 on the
CPU."""

import jax
import numpy as np
import pytest
import torch

from bioreason_tpu import config as JC
from bioreason_tpu.data.text_tokenizer import ByteTextTokenizer as JByte
from bioreason_tpu.models import api as JA
from bioreason_tpu_torch import config as TC
from bioreason_tpu_torch.data.text_tokenizer import ByteTextTokenizer
from bioreason_tpu_torch.models import api as TA
from bioreason_tpu_torch.weights import from_jax_params

# one intra-op thread: the tensors here are tiny, and pytest-xdist runs
# several workers on the host's cores, which torch's default of a thread
# per core oversubscribes many times over
torch.set_num_threads(1)

TEXTS = ["<|im_start|>user\n<|dna_start|><|dna_pad|><|dna_end|>what?<|im_end|>\n"
         "<|im_start|>assistant\n",
         "<|im_start|>user\n<|dna_start|><|dna_pad|><|dna_end|>which pathway is hit by "
         "this one?<|im_end|>\n<|im_start|>assistant\n"]
DNA = [["ACGTACGTACGT"], ["TTGACCATGACGTAGGCA"]]


def pair():
    """(JAX DnaLLM, port DnaLLM) on the same tiny weights."""
    jtok, ttok = JByte(), ByteTextTokenizer()
    jm = JA.DnaLLM(JC.FusionConfig.tiny(text_vocab=jtok.vocab_size,
                                        dna_pad_token_id=jtok.dna_pad_id), text_tokenizer=jtok)
    tcfg = TC.FusionConfig.tiny(text_vocab=ttok.vocab_size, dna_pad_token_id=ttok.dna_pad_id)
    model = from_jax_params(jax.tree.map(np.asarray, jm.params), tcfg, device="cpu")
    return jm, TA.DnaLLM(tcfg, text_tokenizer=ttok, model=model, device="cpu")


def test_dnallm_end_to_end(tmp_path):
    """tests/test_api.py's case on the port: prepare, forward, greedy text,
    save and load back to the same logits."""
    tok = ByteTextTokenizer()
    model = TA.DnaLLM(TC.FusionConfig.tiny(text_vocab=tok.vocab_size,
                                           dna_pad_token_id=tok.dna_pad_id),
                      text_tokenizer=tok, device="cpu")
    batch = model.prepare_inputs(TEXTS[:1], DNA[:1])
    with torch.no_grad():
        logits, _ = model(**batch)
    assert logits.shape[0] == 1
    outs = model.generate_text(TEXTS[:1], DNA[:1], greedy=True,
                               sampling=TC.SamplingConfig(max_new_tokens=4), max_new_tokens=4)
    assert len(outs) == 1 and isinstance(outs[0], str)
    path = str(tmp_path / "m")
    model.save(path)
    model2 = TA.DnaLLM(model.cfg, text_tokenizer=tok, seed=7, device="cpu").load(path)
    with torch.no_grad():
        l2, _ = model2(**batch)
    assert torch.equal(logits, l2)


def test_dnallm_matches_jax():
    """The same weights and prompts: the prepared arrays equal, the logits
    at atol 1e-5, the loss on labels at rel 1e-5, and greedy
    `generate_text` the same strings."""
    jm, tm = pair()
    jb, tb = jm.prepare_inputs(TEXTS, DNA), tm.prepare_inputs(TEXTS, DNA)
    for k in jb:
        np.testing.assert_array_equal(np.asarray(jb[k]), tb[k], err_msg=k)
    jl, _ = jm(**jb)
    with torch.no_grad():
        tl, _ = tm(**tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    labels = np.where(tb["attention_mask"] > 0, tb["input_ids"], -100)
    _, jloss = jm(**jb, labels=labels)
    with torch.no_grad():
        _, tloss = tm(**tb, labels=labels)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    kw = dict(greedy=True, max_new_tokens=6)
    assert tm.generate_text(TEXTS, DNA, **kw) == jm.generate_text(TEXTS, DNA, **kw)


def test_classifier_predict_matches_jax():
    """tests/test_api.py's classifier case on the port, then the JAX
    classifier's weights in the port: the same predictions on the same
    sequences, logits at atol 1e-5."""
    clf = TA.DNAClassifier(TC.EncoderConfig.tiny(), num_classes=3, device="cpu")
    preds = clf.predict(["ACGTACGTACGT", "ACGT"], ["ACGTACGAACGT", "TTTT"], max_length=16)
    assert preds.shape == (2,) and set(preds).issubset({0, 1, 2})
    jclf = JA.DNAClassifier(JC.EncoderConfig.tiny(), num_classes=3, seed=4)
    cfg = TC.EncoderConfig.tiny()
    tclf = TA.DNAClassifier(cfg, num_classes=3, device="cpu",
                            model=from_jax_params(jax.tree.map(np.asarray, jclf.params), cfg,
                                                  device="cpu"))
    ref = ["ACGTACGTACGTTTGA", "ACGT", "GGGGCCCCAAAATTTT"]
    alt = ["ACGTACGAACGTTTGA", "TTTT", "GGGGCCCAAAAATTTT"]
    np.testing.assert_array_equal(tclf.predict(ref, alt, max_length=16),
                                  jclf.predict(ref, alt, max_length=16))
    t = jclf.dna_tokenizer(ref, max_length=16)
    a = jclf.dna_tokenizer(alt, max_length=16, pad_to=t["input_ids"].shape[1])
    args = (t["input_ids"], a["input_ids"], t["attention_mask"], a["attention_mask"])
    np.testing.assert_allclose(tclf(*args).numpy(), np.asarray(jclf(*args)), atol=1e-5, rtol=0)
