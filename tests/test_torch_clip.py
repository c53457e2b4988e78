"""The port's CLIP embedders (``models.clip``, ``models.encoders``) against
the JAX package's wrappers, which run ``transformers``' Flax CLIP, on tiny
random snapshots the test writes: the torch ``CLIPTextModel`` /
``CLIPVisionModel`` saved, their Flax weights converted from them into the
same directory, and a tiny ``vocab.json`` / ``merges.txt`` learnt here.

- token ids equal ``transformers``' ``CLIPTokenizer``'s (which runs its
  ``ftfy``-less path here too) on ASCII, punctuation, contractions,
  digits, accented, CJK, numeric-letter and control characters, and a
  prompt that is truncated;
- text ``last_hidden_state`` (quick_gelu) and image ``pooler_output``
  (exact gelu) within 1e-4 of max(1, max |out|) of the JAX wrappers';
- a full ``CLIPModel`` snapshot (``text_config`` / ``vision_config``)
  loads both towers, held against the torch model's;
- the unCLIP chain of tests/test_unclip.py: image embedding ->
  ``unclip_adm_cond`` given JAX's draws;
- each embedder raises without a card.
"""
import collections
import json

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dsdiff_tpu.core import schedules as JSch  # noqa: E402
from dsdiff_tpu.models import encoders as JE  # noqa: E402
from dsdiff_torch.core import schedules as PSch  # noqa: E402
from dsdiff_torch.models import encoders as PE  # noqa: E402
from dsdiff_torch.models.clip import CLIPTokenizer, bytes_to_unicode  # noqa: E402
from torch_parity_utils import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

RTOL = 1e-4
MAX_LENGTH = 16
PROMPTS = [
    "a photo of a brain MRI scan",
    "T1-weighted, contrast-enhanced: it's the patient's 2nd scan!!",
    "  Café   naïve\tx² ½ Ⅻ  İstanbul 　 脑部 扫描\x07 ok",
    "they'll say we've done it, I'd think; you're sure? 12345",
    " ".join(["a long prompt that is truncated"] * 6),
    "",
]
CORPUS = ("a photo of a brain mri scan the patient contrast enhanced "
          "weighted it is sure they think done long prompt truncated "
          "scan scan photo photo brain brain").split()


def _learn_bpe(words, n_merges):
    """A tiny BPE vocabulary: the byte alphabet (and its end-of-word forms),
    ``n_merges`` merges learnt from ``words``, the two special tokens."""
    byte_chars = list(bytes_to_unicode().values())
    vocab = byte_chars + [c + "</w>" for c in byte_chars]
    seqs = collections.Counter(
        tuple(w[:-1]) + (w[-1] + "</w>",) for w in words)
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for seq, n in seqs.items():
            for p in zip(seq, seq[1:]):
                pairs[p] += n
        if not pairs:
            break
        best = max(sorted(pairs), key=pairs.get)
        merges.append(best)
        vocab.append(best[0] + best[1])
        merged = collections.Counter()
        for seq, n in seqs.items():
            out, i = [], 0
            while i < len(seq):
                if i < len(seq) - 1 and (seq[i], seq[i + 1]) == best:
                    out.append(seq[i] + seq[i + 1])
                    i += 2
                else:
                    out.append(seq[i])
                    i += 1
            merged[tuple(out)] += n
        seqs = merged
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    return {t: i for i, t in enumerate(vocab)}, merges


def _write_tokenizer(path, vocab, merges):
    (path / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (path / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n",
        encoding="utf-8")


def _configs(vocab_size):
    text = transformers.CLIPTextConfig(
        vocab_size=vocab_size, hidden_size=32, intermediate_size=48,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=MAX_LENGTH, hidden_act="quick_gelu",
        layer_norm_eps=1e-5, projection_dim=16)
    vision = transformers.CLIPVisionConfig(
        hidden_size=40, intermediate_size=56, num_hidden_layers=2,
        num_attention_heads=4, image_size=32, patch_size=8,
        hidden_act="gelu", projection_dim=16)
    return text, vision


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """Text and vision snapshots (torch weights + their Flax conversion),
    and a full ``CLIPModel`` torch snapshot."""
    vocab, merges = _learn_bpe(CORPUS, 60)
    text_cfg, vision_cfg = _configs(len(vocab))
    torch.manual_seed(0)
    out = {}
    for name, cls, flax_cls, cfg in (
            ("text", transformers.CLIPTextModel,
             transformers.FlaxCLIPTextModel, text_cfg),
            ("vision", transformers.CLIPVisionModel,
             transformers.FlaxCLIPVisionModel, vision_cfg)):
        path = tmp_path_factory.mktemp(f"clip_{name}")
        model = cls(cfg).eval()
        with torch.no_grad():  # biases and norms off their 0 / 1 inits
            for p in model.parameters():
                p.add_(0.05 * torch.randn_like(p))
        model.save_pretrained(str(path))
        flax_cls.from_pretrained(str(path), from_pt=True).save_pretrained(
            str(path))
        out[name] = (path, model)
    _write_tokenizer(out["text"][0], vocab, merges)
    full = tmp_path_factory.mktemp("clip_full")
    config = transformers.CLIPConfig(text_config=text_cfg.to_dict(),
                                     vision_config=vision_cfg.to_dict())
    full_model = transformers.CLIPModel(config).eval()
    full_model.save_pretrained(str(full))
    _write_tokenizer(full, vocab, merges)
    out["full"] = (full, full_model)
    return out


def _images(seed, n=2):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, 32, 32, 3)).astype(np.float32)


def _hold(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    tol = RTOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_token_ids_equal_transformers_clip_tokenizer(snapshots):
    path = snapshots["text"][0]
    want = transformers.CLIPTokenizer.from_pretrained(str(path))(
        PROMPTS, truncation=True, max_length=MAX_LENGTH,
        padding="max_length", return_tensors="np")["input_ids"]
    tok = CLIPTokenizer.from_pretrained(path)
    got = tok(PROMPTS, MAX_LENGTH)
    assert got.dtype == torch.int64 and got.shape == (len(PROMPTS),
                                                      MAX_LENGTH)
    np.testing.assert_array_equal(got.numpy(), want)
    # the long prompt is truncated to its end token, the empty one padded
    assert got[4, -1] == tok.eos_id and got[5, 2] == tok.pad_id


def test_text_embedder_matches_jax(snapshots):
    path = str(snapshots["text"][0])
    want = JE.CLIPTextEmbedder(path, max_length=MAX_LENGTH)(PROMPTS)
    got = PE.CLIPTextEmbedder(path, max_length=MAX_LENGTH, device="cpu")(
        PROMPTS)
    assert got.shape == (len(PROMPTS), MAX_LENGTH, 32)
    _hold(got.numpy(), want)


def test_image_embedder_matches_jax(snapshots):
    path = str(snapshots["vision"][0])
    images = _images(0)
    want = JE.CLIPImageEmbedder(path)(jnp.asarray(images))
    got = PE.CLIPImageEmbedder(path, device="cpu")(torch.from_numpy(images))
    assert got.shape == (2, 40)
    _hold(got.numpy(), want)


def test_full_clip_snapshot_loads_both_towers(snapshots):
    path, model = snapshots["full"]
    tok = transformers.CLIPTokenizer.from_pretrained(str(path))
    ids = tok(PROMPTS, truncation=True, max_length=MAX_LENGTH,
              padding="max_length", return_tensors="pt")["input_ids"]
    images = _images(1)
    with torch.no_grad():
        want_text = model.text_model(input_ids=ids).last_hidden_state
        want_image = model.vision_model(
            pixel_values=torch.from_numpy(images).permute(0, 3, 1, 2)
        ).pooler_output
    got_text = PE.CLIPTextEmbedder(str(path), max_length=MAX_LENGTH,
                                   device="cpu")(PROMPTS)
    got_image = PE.CLIPImageEmbedder(str(path), device="cpu")(
        torch.from_numpy(images))
    _hold(got_text.numpy(), want_text.numpy())
    _hold(got_image.numpy(), want_image.numpy())


def test_unclip_chain_matches_jax(snapshots):
    """tests/test_unclip.py's chain: CLIP image embedding -> noise
    augmentation + level embedding + row dropout, given JAX's draws."""
    path = str(snapshots["vision"][0])
    images = _images(2)
    emb = JE.CLIPImageEmbedder(path)(jnp.asarray(images))
    betas = JSch.make_beta_schedule("linear", 100)
    jaug = JE.EmbeddingNoiseAugmentation(JSch.DiffusionSchedule.create(betas),
                                         max_noise_level=50)
    rng = jax.random.PRNGKey(0)
    want = JE.unclip_adm_cond(emb, rng, jaug, level_emb_dim=16,
                              embedding_dropout=0.5, deterministic=False)
    a_rng, d_rng = jax.random.split(rng)
    t_rng, n_rng = jax.random.split(a_rng)
    level = np.array(jax.random.randint(t_rng, (2,), 0, 50))
    noise = np.array(jax.random.normal(n_rng, emb.shape, jnp.float32))
    keep = np.array(jax.random.uniform(d_rng, (2, 1)) >= 0.5)[:, 0]
    paug = PE.EmbeddingNoiseAugmentation(
        PSch.DiffusionSchedule.create(betas, device="cpu"), max_noise_level=50)
    got = PE.unclip_adm_cond(
        PE.CLIPImageEmbedder(path, device="cpu")(torch.from_numpy(images)),
        paug, level_emb_dim=16, embedding_dropout=0.5, deterministic=False,
        noise=torch.from_numpy(noise), noise_level=torch.from_numpy(level),
        keep=torch.from_numpy(keep))
    assert got.shape == (2, 40 + 16)
    _hold(got.numpy(), want)


def test_embedders_need_a_card_or_a_snapshot(snapshots, monkeypatch):
    with pytest.raises(ValueError, match="local weights snapshot"):
        PE.CLIPImageEmbedder("", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: PE.CLIPTextEmbedder(str(snapshots["text"][0])),
                 lambda: PE.CLIPImageEmbedder(str(snapshots["vision"][0]))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
