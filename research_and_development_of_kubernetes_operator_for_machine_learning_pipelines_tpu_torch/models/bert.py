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

``mesh`` (a ``parallel.ServingMesh``): ``params`` is this rank's block of
the tree (``models/partition.shard_bert_params``), and the collectives that
XLA inserts in the reference are explicit.  The word embedding holds a
block of vocab rows: ids outside it read zeros and a tp ``psum`` adds the
one rank's row (exact).  q, k, v and up are column-split, so attention runs
the flash kernel at NH/tp heads with the same key bias; o and down are
row-split: a tp ``psum`` of the partial products, then the bias once.
int8 o and down take each row's activation scale as a tp ``pmax`` and sum
the exact int32 products (``quantization.dense_q8(group=)``), so a sharded
rank's int8 logits equal the one-rank port's.  The reference shards no
batch on the predict path, so every dp group runs the whole batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.flash_attention import flash_attention
from ..parallel.collectives import psum
from .common import dense, gelu, gelu_tanh, init_dense, layer_norm, matmul_f32, take_embedding
from .quantization import dense_q8, is_quantized


def _tp_group(mesh):
    """The tp process group (None on one rank or a tp of 1)."""
    return None if mesh is None else mesh.group("tp")


def _dense(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Float weights -> :func:`common.dense`; int8 leaves -> ``dense_q8``."""
    if is_quantized(p["w"]):
        return dense_q8(x, p["w"], p.get("b"))
    return dense(x, p["w"], p["b"])


def _dense_rows(x: torch.Tensor, p: dict, group) -> torch.Tensor:
    """:func:`_dense` of a matrix split on its INPUT axis over ``group``:
    the partial products summed over the group (f32, or int32 for int8
    leaves), then the replicated bias once."""
    if group is None:
        return _dense(x, p)
    if is_quantized(p["w"]):
        return dense_q8(x, p["w"], p.get("b"), group=group)
    y = psum(matmul_f32(x, p["w"].to(x.dtype)), group)
    return (y + p["b"].to(torch.float32)).to(x.dtype)


def _word_embedding(table: torch.Tensor, ids: torch.Tensor, wide, mesh) -> torch.Tensor:
    """The word rows of ``ids`` in ``wide``; at tp > 1 ``table`` is this
    rank's block of vocab rows, ids outside it read zeros, and the tp psum
    adds the one rank's row to zeros (exact)."""
    group = _tp_group(mesh)
    if group is None:
        return take_embedding(table, ids, wide)
    rows = table.shape[0]
    local = ids - mesh.index("tp") * rows
    inside = (local >= 0) & (local < rows)
    x = torch.where(inside[..., None], take_embedding(table, local.clamp(0, rows - 1), wide),
                    torch.zeros((), dtype=wide, device=table.device))
    return psum(x, group)


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
                    cfg: BertConfig, mesh=None) -> torch.Tensor:
    b, s, _ = x.shape
    group = _tp_group(mesh)
    # This rank's heads: q/k/v are column-split over tp.
    nh, hd = cfg.num_heads // (1 if group is None else mesh.tp), cfg.head_dim
    q = _dense(x, p["q"]).view(b, s, nh, hd).transpose(1, 2)
    k = _dense(x, p["k"]).view(b, s, nh, hd).transpose(1, 2)
    v = _dense(x, p["v"]).view(b, s, nh, hd).transpose(1, 2)
    ctx = flash_attention(q, k, v, scale=1.0 / hd**0.5, bias=mask_bias)
    return _dense_rows(ctx.transpose(1, 2).reshape(b, s, nh * hd), p["o"], group)


def encode(
    params: dict,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor | None = None,
    token_type_ids: torch.Tensor | None = None,
    cfg: BertConfig = BertConfig(),
    dtype=torch.float32,
    mesh=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (sequence_output [B, S, H], pooled_output [B, H]); ``mesh``:
    see the module docstring."""
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
        _word_embedding(emb["word"], input_ids.long(), wide, mesh)
        + take_embedding(emb["position"], positions, wide)[None]
        + take_embedding(emb["token_type"], token_type_ids.long(), wide)
    ).to(dtype)
    x = layer_norm(x, emb["ln"]["scale"], emb["ln"]["bias"], cfg.layer_norm_eps)

    # Additive key bias in f32, [B, S]: 0 where attended, -1e9 where masked.
    mask_bias = (1.0 - attention_mask.to(torch.float32)) * -1e9

    act = gelu_tanh if cfg.hidden_act == "gelu_tanh" else gelu
    group = _tp_group(mesh)
    for layer in params["layers"]:
        a = _self_attention(layer["attn"], x, mask_bias, cfg, mesh)
        x = layer_norm(x + a, layer["attn"]["ln"]["scale"], layer["attn"]["ln"]["bias"],
                       cfg.layer_norm_eps)
        m = act(_dense(x, layer["mlp"]["up"]))
        m = _dense_rows(m, layer["mlp"]["down"], group)
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
    mesh=None,
) -> torch.Tensor:
    """Sentence-classification logits [B, num_labels], f32 (every rank of a
    ``mesh`` returns the same)."""
    _, pooled = encode(params, input_ids, attention_mask, token_type_ids, cfg, dtype, mesh)
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
