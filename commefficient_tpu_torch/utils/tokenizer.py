"""Tokenization for the GPT-2 path: the port's copy of the JAX package's
``utils/tokenizer.py``, byte-level only.

The reference fine-tunes with HuggingFace's GPT-2 BPE when its tokenizer
files are on disk and otherwise falls back to a byte-level tokenizer with
the same interface. The port has only the byte-level one: it imports no
``transformers`` (the GPU machine has none), and the BPE path waits until
the tokenizer files are part of the repository. Every pipeline stage
(persona grouping, packing, masking, the LM loss and its perplexity) runs
identically; only the subword inventory differs.
"""

from __future__ import annotations

# PersonaChat dialog specials (transfer-learning-conv-ai): bos/eos frame the
# sequence, speaker1/speaker2 tag utterances (and serve as the token-type
# embedding ids), pad fills to seq_len. Appended to the 256 byte values.
SPECIAL_TOKENS = ("<bos>", "<eos>", "<speaker1>", "<speaker2>", "<pad>")


class ByteTokenizer:
    """Byte-level tokenizer: 256 byte values + the 5 dialog specials."""

    def __init__(self) -> None:
        self.bos_id = 256
        self.eos_id = 257
        self.speaker1_id = 258
        self.speaker2_id = 259
        self.pad_id = 260
        self.vocab_size = 261

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8", errors="replace"))

    def decode(self, ids: "list[int]") -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")


def get_tokenizer() -> ByteTokenizer:
    return ByteTokenizer()
