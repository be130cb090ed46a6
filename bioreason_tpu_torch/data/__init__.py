from bioreason_tpu_torch.data.chat_template import apply_chat_template, render_chat
from bioreason_tpu_torch.data.kegg import (format_kegg_for_dna_llm, format_kegg_prompt_only,
                                           synthetic_kegg_items)
from bioreason_tpu_torch.data.nt_tokenizer import KmerTokenizer
from bioreason_tpu_torch.data.processor import BioProcessor, ProcessorOutput
from bioreason_tpu_torch.data.text_tokenizer import ByteTextTokenizer

__all__ = ["apply_chat_template", "render_chat", "format_kegg_for_dna_llm",
           "format_kegg_prompt_only", "synthetic_kegg_items",
           "KmerTokenizer", "BioProcessor", "ProcessorOutput", "ByteTextTokenizer"]
