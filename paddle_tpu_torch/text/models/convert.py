"""Checkpoint interop: HuggingFace state dicts into the port's models.
Counterpart of ``paddle_tpu/text/models/convert.py`` (Llama, ViT, BERT,
T5), with its own copy of the name maps.

``convert_hf_*_state_dict`` takes a HuggingFace state dict (torch
tensors or numpy arrays, keyed by HF names) and returns numpy arrays
keyed by the port's ``state_dict`` names, which are the JAX package's:
HF ``Linear`` weights ``[out, in]`` are transposed to paddle's ``[in,
out]``, names are mapped, and what the models compute on the fly or
alias (rotary tables, ``position_ids``, poolers the model lacks, T5's
``embed_tokens``) is dropped. The arrays equal the JAX converters'
(a bf16 tensor is read as float32 first; numpy has no bf16).

``load_hf_*_weights(model, hf_state, strict=True)`` copies the converted
arrays into the model's parameters in their own dtype and device. With
``strict`` a missing or unexpected name raises ``ValueError`` (a tied T5
tolerates ``lm_head.weight``, an alias of ``shared``); a shape mismatch
always raises, with JAX's messages.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["convert_hf_llama_state_dict", "convert_hf_vit_state_dict",
           "convert_hf_bert_state_dict", "convert_hf_t5_state_dict",
           "load_hf_llama_weights", "load_hf_vit_weights",
           "load_hf_bert_weights", "load_hf_t5_weights"]

_LINEAR_SUFFIXES = (
    "q_proj.weight", "k_proj.weight", "v_proj.weight", "o_proj.weight",
    "gate_proj.weight", "up_proj.weight", "down_proj.weight",
)


def _array(val):
    """A torch tensor or array-like as a numpy array."""
    if isinstance(val, torch.Tensor):
        val = val.detach().cpu()
        return (val.float() if val.dtype == torch.bfloat16 else val).numpy()
    return np.asarray(val)


def _load(model, converted, strict, shown, tolerated=()):
    """Copy ``converted`` into ``model``'s parameters (their dtype and
    device); raise on a strict name mismatch and on any shape mismatch."""
    params = dict(model.named_parameters())
    missing = [k for k in params if k not in converted]
    unexpected = [k for k in converted
                  if k not in params and k not in tolerated]
    if strict and (missing or unexpected):
        raise ValueError(f"state dict mismatch: missing={missing[:shown]} "
                         f"unexpected={unexpected[:shown]}")
    with torch.no_grad():
        for k, p in params.items():
            if k in converted:
                src = converted[k]
                if tuple(src.shape) != tuple(p.shape):
                    raise ValueError(
                        f"{k}: shape {src.shape} != {tuple(p.shape)}")
                p.copy_(torch.from_numpy(np.ascontiguousarray(src)))
    return model


def convert_hf_llama_state_dict(hf_state: dict) -> dict:
    """HF LlamaForCausalLM state dict -> the port's LlamaForCausalLM."""
    out = {}
    for name, val in hf_state.items():
        arr = _array(val)
        if name.startswith("model."):
            ours = "llama." + name[len("model."):]
        elif name == "lm_head.weight":
            out["lm_head.weight"] = arr.T  # [V, H] -> [H, V]
            continue
        else:
            ours = name
        if ours.endswith(_LINEAR_SUFFIXES):
            arr = arr.T  # torch [out, in] -> paddle [in, out]
        if "rotary_emb" in ours:
            continue  # computed on the fly
        out[ours] = arr
    return out


def load_hf_llama_weights(model, hf_state: dict, strict: bool = True):
    """Copy converted HF weights into the port's LlamaForCausalLM."""
    return _load(model, convert_hf_llama_state_dict(hf_state), strict, 5)


_VIT_LAYER_MAP = {
    "attention.attention.query": "self_attn.q_proj",
    "attention.attention.key": "self_attn.k_proj",
    "attention.attention.value": "self_attn.v_proj",
    "attention.output.dense": "self_attn.out_proj",
    "layernorm_before": "norm1",
    "layernorm_after": "norm2",
    "intermediate.dense": "linear1",
    "output.dense": "linear2",
}


def convert_hf_vit_state_dict(hf_state: dict) -> dict:
    """HF ViTModel/ViTForImageClassification state dict -> the port's
    VisionTransformer."""
    out = {}
    for name, val in hf_state.items():
        arr = _array(val)
        ours = name
        if ours.startswith("vit."):
            ours = ours[len("vit."):]
        if ours == "embeddings.cls_token":
            ours = "cls_token"
        elif ours == "embeddings.position_embeddings":
            ours = "pos_embed"
        elif ours.startswith("embeddings.patch_embeddings.projection."):
            ours = "patch_embed.proj." + ours.rsplit(".", 1)[-1]
        elif ours.startswith("encoder.layer."):
            parts = ours.split(".")
            mapped = _VIT_LAYER_MAP.get(".".join(parts[3:-1]))
            if mapped is None:
                continue
            suffix = parts[-1]
            ours = f"encoder.layers.{parts[2]}.{mapped}.{suffix}"
            if suffix == "weight" and arr.ndim == 2:
                arr = arr.T
        elif ours.startswith("layernorm."):
            ours = "encoder.norm." + ours.rsplit(".", 1)[-1]
        elif ours.startswith("classifier."):
            ours = "head." + ours.rsplit(".", 1)[-1]
            if ours.endswith("weight"):
                arr = arr.T
        elif "pooler" in ours:
            continue
        out[ours] = arr
    return out


def load_hf_vit_weights(model, hf_state: dict, strict: bool = True):
    return _load(model, convert_hf_vit_state_dict(hf_state), strict, 6)


_BERT_LAYER_MAP = {
    "attention.self.query": "self_attn.q_proj",
    "attention.self.key": "self_attn.k_proj",
    "attention.self.value": "self_attn.v_proj",
    "attention.output.dense": "self_attn.out_proj",
    "attention.output.LayerNorm": "norm1",
    "intermediate.dense": "linear1",
    "output.dense": "linear2",
    "output.LayerNorm": "norm2",
}


def convert_hf_bert_state_dict(hf_state: dict) -> dict:
    """HF BertModel state dict -> the port's BertModel."""
    out = {}
    for name, val in hf_state.items():
        arr = _array(val)
        ours = name
        if ours.startswith("bert."):
            ours = ours[len("bert."):]
        if ours.startswith("embeddings."):
            ours = ours.replace("LayerNorm", "layer_norm")
        elif ours.startswith("encoder.layer."):
            parts = ours.split(".")
            mapped = _BERT_LAYER_MAP.get(".".join(parts[3:-1]))
            if mapped is None:
                continue
            ours = f"encoder.layers.{parts[2]}.{mapped}.{parts[-1]}"
        elif "position_ids" in ours:
            continue
        if ours.endswith(".weight") and arr.ndim == 2 \
                and "embeddings" not in ours:
            arr = arr.T  # torch Linear [out, in] -> paddle [in, out]
        out[ours] = arr
    return out


def load_hf_bert_weights(model, hf_state: dict, strict: bool = True):
    """Copy converted HF BertModel weights into the port's BertModel."""
    return _load(model, convert_hf_bert_state_dict(hf_state), strict, 6)


def _t5_map_layer(parts, is_decoder):
    """HF t5 block sublayer path -> ours."""
    sub, rest = parts[0], parts[1:]  # sub: "0"/"1"/"2"
    if sub == "0":
        if rest[0] == "SelfAttention":
            if rest[1] == "relative_attention_bias":
                return "self_attn.relative_attention_bias." + rest[-1]
            return f"self_attn.{rest[1]}.{rest[-1]}"
        if rest[0] == "layer_norm":
            return "ln1." + rest[-1]
    if is_decoder and sub == "1":
        if rest[0] == "EncDecAttention":
            return f"cross_attn.{rest[1]}.{rest[-1]}"
        if rest[0] == "layer_norm":
            return "ln_cross." + rest[-1]
    # feed-forward sublayer: 1 (encoder) or 2 (decoder)
    if rest[0] == "DenseReluDense":
        return f"ff.{rest[1]}.{rest[-1]}"
    if rest[0] == "layer_norm":
        return "ln2." + rest[-1]
    return None


def convert_hf_t5_state_dict(hf_state: dict) -> dict:
    """HF T5ForConditionalGeneration state dict -> the port's T5."""
    out = {}
    for name, val in hf_state.items():
        arr = _array(val)
        parts = name.split(".")
        ours = None
        if name == "shared.weight":
            ours = "t5.shared.weight"
        elif name == "lm_head.weight":
            out["lm_head.weight"] = arr.T
            continue
        elif parts[0] in ("encoder", "decoder"):
            if parts[1] == "embed_tokens":
                continue  # alias of shared
            if parts[1] == "final_layer_norm":
                ours = f"t5.{parts[0]}.final_layer_norm.{parts[-1]}"
            elif parts[1] == "block":
                # encoder.block.<i>.layer.<j>.<Module>...
                mapped = _t5_map_layer(parts[4:], parts[0] == "decoder")
                if mapped is None:
                    continue
                ours = f"t5.{parts[0]}.blocks.{parts[2]}.{mapped}"
        if ours is None:
            continue
        if (ours.endswith(".weight") and arr.ndim == 2
                and "shared" not in ours
                and "relative_attention_bias" not in ours):
            arr = arr.T
        out[ours] = arr
    return out


def load_hf_t5_weights(model, hf_state: dict, strict: bool = True):
    """Copy converted HF T5 weights into the port's model; a tied model
    ignores ``lm_head.weight`` (an alias of ``shared``)."""
    return _load(model, convert_hf_t5_state_dict(hf_state), strict, 6,
                 tolerated=("lm_head.weight",))
