"""BERT encoder and sentence classifier in PyTorch (port of the JAX
package's ``models/bert.py``).

Post-LayerNorm, HuggingFace ``BertModel`` semantics, the reference's
parameter tree: ``layers`` is a list of ``{"attn": {q, k, v, o, ln},
"mlp": {up, down, ln}}`` dicts whose dense leaves are ``{"w", "b"}``,
or ``{"w": {"q8", "scale"}, "b"}`` after ``quantize_bert``.

Kernel on this path: every layer's attention goes through
``ops.flash_attention`` (one launch per layer on the card; its plain
version on the CPU).  The q/k/v projections go in as ``[B, NH, S, HD]``
views of their ``[B, S, NH, HD]`` outputs and the context comes back in
the same layout, so attention adds no transpose or copy.  The reference
divides the f32 scores by sqrt(head_dim); the kernel multiplies q by
1/sqrt(head_dim) first, which differs by rounding only (nothing at
head_dim 16 or 64, where the scale is a power of two).

``from_torch`` converts a HuggingFace checkpoint into the tree (the
loader's HF branch).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.flash_attention import flash_attention
from .common import dense, gelu, gelu_tanh, init_dense, layer_norm, take_embedding
from .quantization import dense_q8, is_quantized


def _dense(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Float weights -> :func:`common.dense`; int8 leaves -> ``dense_q8``."""
    if is_quantized(p["w"]):
        return dense_q8(x, p["w"], p.get("b"))
    return dense(x, p["w"], p["b"])


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    num_labels: int = 2  # classifier head; 0 disables
    # "gelu" = exact erf; "gelu_tanh" = the tanh approximation, which the
    # int8 load path selects unless the artifact pins hidden_act.
    hidden_act: str = "gelu"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def base(cls, **kw) -> "BertConfig":
        """BERT-base: Google's published ``bert-base-uncased`` config."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "BertConfig":
        """Small config for tests."""
        defaults = dict(
            vocab_size=512,
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            intermediate_size=128,
            max_position_embeddings=128,
        )
        defaults.update(kw)
        return cls(**defaults)


def _init_ln(h: int, dtype, device) -> dict:
    return {"scale": torch.ones((h,), dtype=dtype, device=device),
            "bias": torch.zeros((h,), dtype=dtype, device=device)}


def init(gen: torch.Generator, cfg: BertConfig, dtype=torch.float32, device=None) -> dict:
    """Random weights from ``gen`` (normal, std 0.02, for the embeddings;
    ``init_dense`` for every dense layer), in the reference's layout."""
    h, i = cfg.hidden_size, cfg.intermediate_size

    def normal(shape):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (0.02 * w).to(dtype)

    def lin(d_in, d_out):
        return init_dense(gen, d_in, d_out, dtype, device)

    params: dict = {
        "embeddings": {
            "word": normal((cfg.vocab_size, h)),
            "position": normal((cfg.max_position_embeddings, h)),
            "token_type": normal((cfg.type_vocab_size, h)),
            "ln": _init_ln(h, dtype, device),
        },
        "layers": [],
        "pooler": lin(h, h),
    }
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "attn": {"q": lin(h, h), "k": lin(h, h), "v": lin(h, h), "o": lin(h, h),
                     "ln": _init_ln(h, dtype, device)},
            "mlp": {"up": lin(h, i), "down": lin(i, h), "ln": _init_ln(h, dtype, device)},
        })
    if cfg.num_labels:
        params["classifier"] = lin(h, cfg.num_labels)
    return params


def _self_attention(p: dict, x: torch.Tensor, mask_bias: torch.Tensor,
                    cfg: BertConfig) -> torch.Tensor:
    b, s, h = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    q = _dense(x, p["q"]).view(b, s, nh, hd).transpose(1, 2)
    k = _dense(x, p["k"]).view(b, s, nh, hd).transpose(1, 2)
    v = _dense(x, p["v"]).view(b, s, nh, hd).transpose(1, 2)
    ctx = flash_attention(q, k, v, scale=1.0 / hd**0.5, bias=mask_bias)
    return _dense(ctx.transpose(1, 2).reshape(b, s, h), p["o"])


def encode(
    params: dict,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor | None = None,
    token_type_ids: torch.Tensor | None = None,
    cfg: BertConfig = BertConfig(),
    dtype=torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (sequence_output [B, S, H], pooled_output [B, H])."""
    b, s = input_ids.shape
    dev = input_ids.device
    if attention_mask is None:
        attention_mask = torch.ones((b, s), dtype=torch.int32, device=dev)
    if token_type_ids is None:
        token_type_ids = torch.zeros((b, s), dtype=torch.int32, device=dev)

    emb = params["embeddings"]
    # The three rows are summed at least in f32, then cast once.
    wide = torch.promote_types(emb["word"].dtype, torch.float32)
    positions = torch.arange(s, device=dev)
    x = (
        take_embedding(emb["word"], input_ids.long(), wide)
        + take_embedding(emb["position"], positions, wide)[None]
        + take_embedding(emb["token_type"], token_type_ids.long(), wide)
    ).to(dtype)
    x = layer_norm(x, emb["ln"]["scale"], emb["ln"]["bias"], cfg.layer_norm_eps)

    # Additive key bias in f32, [B, S]: 0 where attended, -1e9 where masked.
    mask_bias = (1.0 - attention_mask.to(torch.float32)) * -1e9

    act = gelu_tanh if cfg.hidden_act == "gelu_tanh" else gelu
    for layer in params["layers"]:
        a = _self_attention(layer["attn"], x, mask_bias, cfg)
        x = layer_norm(x + a, layer["attn"]["ln"]["scale"], layer["attn"]["ln"]["bias"],
                       cfg.layer_norm_eps)
        m = act(_dense(x, layer["mlp"]["up"]))
        m = _dense(m, layer["mlp"]["down"])
        x = layer_norm(x + m, layer["mlp"]["ln"]["scale"], layer["mlp"]["ln"]["bias"],
                       cfg.layer_norm_eps)

    pooled = torch.tanh(dense(x[:, 0], params["pooler"]["w"], params["pooler"]["b"]))
    return x, pooled


def classify(
    params: dict,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor | None = None,
    token_type_ids: torch.Tensor | None = None,
    cfg: BertConfig = BertConfig(),
    dtype=torch.float32,
) -> torch.Tensor:
    """Sentence-classification logits [B, num_labels], f32."""
    _, pooled = encode(params, input_ids, attention_mask, token_type_ids, cfg, dtype)
    c = params["classifier"]
    return dense(pooled, c["w"], c["b"]).to(torch.float32)


def from_torch(torch_model, cfg: BertConfig) -> dict:
    """Convert a HuggingFace ``BertModel`` or ``BertForSequenceClassification``
    (or its state dict) into the parameter tree, float32 on the CPU, dense
    weights transposed to ``[in, out]``."""
    sd = torch_model if isinstance(torch_model, dict) else torch_model.state_dict()
    sd = {k: v.detach().cpu().float() for k, v in sd.items()}
    prefix = "bert." if any(k.startswith("bert.") for k in sd) else ""

    def t(name):
        return sd[prefix + name].contiguous()

    def lin(name):
        return {"w": t(f"{name}.weight").T.contiguous(), "b": t(f"{name}.bias")}

    def ln(name):
        return {"scale": t(f"{name}.weight"), "bias": t(f"{name}.bias")}

    params = {
        "embeddings": {
            "word": t("embeddings.word_embeddings.weight"),
            "position": t("embeddings.position_embeddings.weight"),
            "token_type": t("embeddings.token_type_embeddings.weight"),
            "ln": ln("embeddings.LayerNorm"),
        },
        "layers": [],
        "pooler": lin("pooler.dense"),
    }
    for i in range(cfg.num_layers):
        base = f"encoder.layer.{i}"
        params["layers"].append({
            "attn": {
                "q": lin(f"{base}.attention.self.query"),
                "k": lin(f"{base}.attention.self.key"),
                "v": lin(f"{base}.attention.self.value"),
                "o": lin(f"{base}.attention.output.dense"),
                "ln": ln(f"{base}.attention.output.LayerNorm"),
            },
            "mlp": {
                "up": lin(f"{base}.intermediate.dense"),
                "down": lin(f"{base}.output.dense"),
                "ln": ln(f"{base}.output.LayerNorm"),
            },
        })
    if "classifier.weight" in sd:
        params["classifier"] = {"w": sd["classifier.weight"].T.contiguous(),
                                "b": sd["classifier.bias"].contiguous()}
    return params
