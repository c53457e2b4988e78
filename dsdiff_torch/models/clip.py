"""CLIP's text and image towers and its byte-level BPE tokenizer, read from a
local snapshot: the port's stand-in for ``transformers``' ``CLIPTextModel``,
``CLIPVisionModel`` and ``CLIPTokenizer``, which the JAX package's CLIP
wrappers load (as their Flax models). The port needs neither
``transformers`` nor its ``regex`` / ``ftfy`` / ``safetensors`` packages.

A snapshot is a directory holding ``config.json`` (a ``CLIPModel``'s, with
``text_config`` / ``vision_config``, or one tower's, ``model_type``
``clip_text_model`` / ``clip_vision_model``; absent keys take
``transformers``' defaults, since ``save_pretrained`` writes only the keys
that differ from them) and ``model.safetensors`` or ``pytorch_model.bin``
with the torch key names (``text_model.*``, ``vision_model.*``; the
projections of a full ``CLIPModel`` are not read, nor an old file's
``position_ids`` buffer). The modules carry those names, including the
spelling ``pre_layrnorm``. The tokenizer reads ``vocab.json`` and
``merges.txt``, and its special tokens from ``special_tokens_map.json`` or
``tokenizer_config.json`` where present.

- Text tower: token plus position embeddings, pre-LN layers with a causal
  mask and no padding mask, ``final_layer_norm``; returns
  ``last_hidden_state`` [B, N, D]. Its causal attention is plain PyTorch
  math: the attention kernel computes non-causal attention only.
- Image tower: a bias-free patch conv on NCHW pixels, the class token,
  positions, ``pre_layrnorm``, the layers (non-causal attention through
  ``ops.scaled_attention``: the attention kernel on a CUDA tensor), then
  ``post_layernorm`` of the class token: ``pooler_output`` [B, D].
- Activations by the config's name: ``quick_gelu`` is ``x * sigmoid(1.702
  x)``, ``gelu`` the exact (erf) GELU.
- Tokenizer: ``CLIPTokenizer``'s path without ``ftfy``: control characters
  dropped, whitespace collapsed, CJK characters spaced, NFC, lower case,
  then CLIP's pre-tokenizer pattern and BPE over the bytes, framed by the
  start and end tokens, truncated and padded to ``max_length`` with the
  pad token. The pattern's ``\\p{L}`` / ``\\p{N}`` classes are read from
  ``unicodedata`` categories (L*, N*), so they differ from the ``regex``
  package's only where the two Unicode databases' versions differ.
"""
from __future__ import annotations

import json
import math
import unicodedata
from pathlib import Path

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import scaled_attention
from ..utils import torch_io

__all__ = ["CLIPTextTransformer", "CLIPVisionTransformer", "CLIPTokenizer",
           "read_clip_config", "load_clip_tower", "bytes_to_unicode"]

# transformers' CLIPTextConfig / CLIPVisionConfig defaults, for the keys the
# towers read
TEXT_DEFAULTS = dict(vocab_size=49408, hidden_size=512,
                     intermediate_size=2048, num_hidden_layers=12,
                     num_attention_heads=8, max_position_embeddings=77,
                     hidden_act="quick_gelu", layer_norm_eps=1e-5)
VISION_DEFAULTS = dict(hidden_size=768, intermediate_size=3072,
                       num_hidden_layers=12, num_attention_heads=12,
                       num_channels=3, image_size=224, patch_size=32,
                       hidden_act="quick_gelu", layer_norm_eps=1e-5)
_DEFAULTS = {"text": TEXT_DEFAULTS, "vision": VISION_DEFAULTS}

_ACTIVATIONS = {
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "gelu": F.gelu,  # the exact erf form, as transformers' "gelu"
}


def read_clip_config(path, tower: str) -> dict:
    """The ``tower`` ('text' or 'vision') config of the snapshot at
    ``path``, every key the tower reads filled in."""
    cfg = json.loads((Path(path) / "config.json").read_text())
    if cfg.get("model_type") == f"clip_{tower}_model":
        sub = cfg
    elif cfg.get("model_type") == "clip" or f"{tower}_config" in cfg:
        sub = cfg.get(f"{tower}_config") or {}
    else:
        raise ValueError(f"{path}/config.json holds no CLIP {tower} config")
    out = dict(_DEFAULTS[tower])
    out.update({k: sub[k] for k in out if k in sub})
    if out["hidden_act"] not in _ACTIVATIONS:
        raise ValueError(f"CLIP activation '{out['hidden_act']}' is not "
                         f"one of {sorted(_ACTIVATIONS)}")
    return out


class CLIPAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        B, N, D = x.shape
        q, k, v = (p(x).view(B, N, self.heads, D // self.heads)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        if causal:
            s = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(q.shape[-1])
            future = torch.ones(N, N, dtype=torch.bool,
                                device=x.device).triu(1)
            w = torch.softmax(s.masked_fill(future, float("-inf")), dim=-1)
            o = torch.einsum("bhnm,bmhd->bnhd", w, v)
        else:
            o = scaled_attention(q, k, v)
        return self.out_proj(o.reshape(B, N, D))


class CLIPMLP(nn.Module):
    def __init__(self, width: int, hidden: int, act: str):
        super().__init__()
        self.act = _ACTIVATIONS[act]
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        D, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        self.self_attn = CLIPAttention(D, cfg["num_attention_heads"])
        self.layer_norm1 = nn.LayerNorm(D, eps=eps)
        self.mlp = CLIPMLP(D, cfg["intermediate_size"], cfg["hidden_act"])
        self.layer_norm2 = nn.LayerNorm(D, eps=eps)

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg)
                                    for _ in range(cfg["num_hidden_layers"]))

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, causal)
        return x


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        D = cfg["hidden_size"]
        self.token_embedding = nn.Embedding(cfg["vocab_size"], D)
        self.position_embedding = nn.Embedding(cfg["max_position_embeddings"],
                                               D)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(ids.shape[1], device=ids.device)
        return self.token_embedding(ids) + self.position_embedding(pos)


class CLIPTextTransformer(nn.Module):
    """Token ids [B, N] -> ``last_hidden_state`` [B, N, D]."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg["hidden_size"],
                                             eps=cfg["layer_norm_eps"])

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.final_layer_norm(self.encoder(self.embeddings(ids),
                                                  causal=True))


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        D, P = cfg["hidden_size"], cfg["patch_size"]
        self.class_embedding = nn.Parameter(torch.zeros(D))
        self.patch_embedding = nn.Conv2d(cfg["num_channels"], D, P, stride=P,
                                         bias=False)
        self.position_embedding = nn.Embedding(
            (cfg["image_size"] // P) ** 2 + 1, D)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        patches = self.patch_embedding(pixels).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(pixels.shape[0], 1, -1)
        return torch.cat([cls, patches], dim=1) + self.position_embedding.weight


class CLIPVisionTransformer(nn.Module):
    """Pixels [B, C, H, W] -> ``pooler_output`` [B, D], the class token
    after ``post_layernorm``."""

    def __init__(self, cfg: dict):
        super().__init__()
        D, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(D, eps=eps)
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = nn.LayerNorm(D, eps=eps)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        h = self.encoder(self.pre_layrnorm(self.embeddings(pixels)),
                         causal=False)
        return self.post_layernorm(h[:, 0])


_TOWERS = {"text": CLIPTextTransformer, "vision": CLIPVisionTransformer}
_WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin")


def load_clip_tower(path, tower: str, device) -> nn.Module:
    """The frozen ``tower`` ('text' or 'vision') of the snapshot at
    ``path`` in f32 on ``device``. Raises if the snapshot has no weight
    file or a weight of the tower is missing."""
    path = Path(path)
    with torch.device("meta"):  # no initialisation: the file fills it
        model = _TOWERS[tower](read_clip_config(path, tower))
    files = [path / f for f in _WEIGHT_FILES if (path / f).is_file()]
    if not files:
        raise FileNotFoundError(f"{path} holds none of {_WEIGHT_FILES}")
    prefix = f"{tower}_model."
    state = {k[len(prefix):]: v
             for k, v in torch_io.load_checkpoint(files[0]).items()
             if k.startswith(prefix) and not k.endswith("position_ids")}
    model.load_state_dict(state, assign=True)
    return model.to(device).requires_grad_(False).eval()


# ------------------------------------------------------------------ tokenizer
def bytes_to_unicode() -> dict:
    """GPT-2's reversible byte -> printable character table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _basic_clean(text: str) -> str:
    """``transformers``' BasicTokenizer as CLIPTokenizer runs it without
    ``ftfy`` (no accent stripping, no punctuation split): control
    characters dropped, whitespace made spaces, CJK characters spaced,
    NFC, lower case, whitespace collapsed."""
    out = []
    for ch in text:
        cp = ord(ch)
        if ch in " \t\n\r" or unicodedata.category(ch) == "Zs":
            out.append(" ")
        elif cp == 0 or cp == 0xFFFD or unicodedata.category(ch)[0] == "C":
            continue
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    words = unicodedata.normalize("NFC", "".join(out)).split()
    return " ".join(" ".join(w.lower() for w in words).split())


_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _char_class(ch: str) -> str:
    cat = unicodedata.category(ch)[0]
    if cat in "LN":
        return cat
    return " " if ch.isspace() else "P"


def _pretokenize(text: str) -> list:
    """``findall`` of CLIP's pattern ``<|startoftext|>|<|endoftext|>|'s|'t|
    're|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`` (on lower-case
    text): at each position the first alternative that matches."""
    out, i, n = [], 0, len(text)
    while i < n:
        kind = _char_class(text[i])
        if kind == " ":
            i += 1
            continue
        tok = next((t for t in _SPECIALS + _CONTRACTIONS
                    if text.startswith(t, i)), None)
        if tok is None:
            j = i + 1
            if kind != "N":  # one digit a token; letter or other runs
                while j < n and _char_class(text[j]) == kind:
                    j += 1
            tok = text[i:j]
        out.append(tok)
        i += len(tok)
    return out


def _special(path: Path, name: str, default: str) -> str:
    """A special token from the snapshot's tokenizer files, else
    ``default``."""
    for f in ("special_tokens_map.json", "tokenizer_config.json"):
        if (path / f).is_file():
            val = json.loads((path / f).read_text()).get(name)
            if isinstance(val, dict):
                val = val.get("content")
            if isinstance(val, str):
                return val
    return default


class CLIPTokenizer:
    """CLIP's byte-level BPE over a snapshot's ``vocab.json`` and
    ``merges.txt``; ``tokenizer(texts, max_length)`` -> ids [B,
    max_length] (int64)."""

    def __init__(self, vocab_file, merges_file,
                 bos_token: str = "<|startoftext|>",
                 eos_token: str = "<|endoftext|>",
                 pad_token: str = "<|endoftext|>",
                 unk_token: str = "<|endoftext|>"):
        self.encoder = json.loads(Path(vocab_file).read_text(encoding="utf-8"))
        merges = Path(merges_file).read_text(encoding="utf-8").strip().split(
            "\n")[1:49152 - 256 - 2 + 1]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.cache = {t: t for t in _SPECIALS}
        try:
            self.bos_id, self.eos_id, self.pad_id, self.unk_id = (
                self.encoder[t] for t in (bos_token, eos_token, pad_token,
                                          unk_token))
        except KeyError as e:
            raise ValueError(f"special token {e} is not in the vocabulary") \
                from e

    @classmethod
    def from_pretrained(cls, path) -> "CLIPTokenizer":
        path = Path(path)
        return cls(path / "vocab.json", path / "merges.txt",
                   **{f"{n}_token": _special(path, f"{n}_token", d)
                      for n, d in (("bos", "<|startoftext|>"),
                                   ("eos", "<|endoftext|>"),
                                   ("pad", "<|endoftext|>"),
                                   ("unk", "<|endoftext|>"))})

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, math.inf))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            merged, i = [], 0
            while i < len(word):
                if (word[i] == first and i < len(word) - 1
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        self.cache[token] = " ".join(word)
        return self.cache[token]

    def encode(self, text: str) -> list:
        """The ids of ``text``'s tokens, without the start and end tokens."""
        ids = []
        for piece in _pretokenize(_basic_clean(text)):
            piece = "".join(self.byte_encoder[b] for b in piece.encode())
            ids.extend(self.encoder.get(t, self.unk_id)
                       for t in self.bpe(piece).split(" "))
        return ids

    def __call__(self, texts, max_length: int = 77) -> torch.Tensor:
        rows = []
        for text in texts:
            ids = ([self.bos_id] + self.encode(text)[:max_length - 2]
                   + [self.eos_id])
            rows.append(ids + [self.pad_id] * (max_length - len(ids)))
        return torch.tensor(rows, dtype=torch.int64)
