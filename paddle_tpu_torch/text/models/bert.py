"""BERT. Counterpart of ``paddle_tpu/text/models/bert.py`` (pretraining
with MLM + NSP, and sequence classification).

The same config, parameter names and layouts as the JAX package
(``embeddings.*``, ``encoder.layers.<i>.*`` of the post-LN
``TransformerEncoderLayer`` with erf GELU, ``pooler.dense``, and the
pretraining heads ``cls.transform`` / ``cls.layer_norm`` /
``cls.decoder`` / ``cls.seq_relationship``), so a JAX model's weights
carry across with ``framework.io.load_numpy_state_dict``. As in JAX:

- ``position_ids`` default to ``arange(L)[None]`` and ``token_type_ids``
  to zeros ``[1, L]``, broadcast over the batch;
- a 2-D ``attention_mask`` (1 keep, 0 pad) becomes the additive float
  mask ``(1 - m)[:, None, None, :] * -1e30``; a mask of another rank is
  passed on as it is;
- the heads' ``LayerNorm`` has the default eps 1e-5, not
  ``layer_norm_eps``, and the MLM ``decoder`` is a ``Linear`` of its own
  (not tied to the word embeddings);
- the loss is the fp32 CE of the MLM logits over ``[B * L, V]`` with
  ``ignore_index=-100`` (mean over the kept labels), plus the NSP CE when
  ``next_sentence_label`` is given.

Attention goes through ``F.scaled_dot_product_attention``: without a
mask and outside training dropout it reaches the flash kernels
(non-causal, head dim 64 at BERT-base), otherwise the plain composite.
The models are built in float32 on ``device`` (default: the framework's,
``cuda``); ``model.to(torch.bfloat16)`` casts them, as ``bench_bert``
casts the JAX model.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ...framework.device import resolve_device
from ...nn import (GELU, Dropout, Embedding, LayerNorm, Linear, Tanh,
                   TransformerEncoder, TransformerEncoderLayer)
from ...nn import functional as F

__all__ = ["BertConfig", "BERT_BASE", "BERT_LARGE", "BERT_TINY",
           "BertEmbeddings", "BertPooler", "BertModel",
           "BertPretrainingHeads", "BertForPretraining",
           "BertForSequenceClassification"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12


BERT_BASE = BertConfig()
BERT_LARGE = BertConfig(hidden_size=1024, num_hidden_layers=24,
                        num_attention_heads=16, intermediate_size=4096)
BERT_TINY = BertConfig(vocab_size=1024, hidden_size=128, num_hidden_layers=2,
                       num_attention_heads=2, intermediate_size=512,
                       max_position_embeddings=128)


def _on(x, device):
    """``x`` (array or tensor) as an int64 tensor on ``device``; None
    stays None."""
    return None if x is None else torch.as_tensor(x, device=device).long()


class BertEmbeddings(nn.Module):
    def __init__(self, c: BertConfig, *, device=None):
        super().__init__()
        kw = dict(device=device)
        self.word_embeddings = Embedding(c.vocab_size, c.hidden_size, **kw)
        self.position_embeddings = Embedding(c.max_position_embeddings,
                                             c.hidden_size, **kw)
        self.token_type_embeddings = Embedding(c.type_vocab_size,
                                               c.hidden_size, **kw)
        self.layer_norm = LayerNorm(c.hidden_size, epsilon=c.layer_norm_eps,
                                    **kw)
        self.dropout = Dropout(c.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        l = input_ids.shape[1]
        dev = input_ids.device
        if position_ids is None:
            position_ids = torch.arange(l, device=dev)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros((1, l), dtype=torch.long,
                                         device=dev)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class BertPooler(nn.Module):
    def __init__(self, hidden_size, *, device=None):
        super().__init__()
        self.dense = Linear(hidden_size, hidden_size, device=device)
        self.activation = Tanh()

    def forward(self, hidden):
        return self.activation(self.dense(hidden[:, 0]))


class BertModel(nn.Module):
    """Embeddings, the post-LN encoder and the pooler: ``(seq [B, L, H],
    pooled [B, H])``."""

    def __init__(self, config: BertConfig = BERT_BASE, *, device=None):
        super().__init__()
        self.config = config
        self.device = resolve_device(device)
        kw = dict(device=self.device)
        self.embeddings = BertEmbeddings(config, **kw)
        enc_layer = TransformerEncoderLayer(
            config.hidden_size, config.num_attention_heads,
            config.intermediate_size, dropout=config.hidden_dropout_prob,
            activation="gelu",
            attn_dropout=config.attention_probs_dropout_prob, **kw)
        self.encoder = TransformerEncoder(enc_layer, config.num_hidden_layers)
        self.pooler = BertPooler(config.hidden_size, **kw)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        dev = self.device
        emb = self.embeddings(_on(input_ids, dev), _on(token_type_ids, dev),
                              _on(position_ids, dev))
        if attention_mask is not None:
            attention_mask = torch.as_tensor(attention_mask, device=dev)
            if attention_mask.dim() == 2:
                m = attention_mask.float()[:, None, None, :]
                attention_mask = (1.0 - m) * -1e30
        seq = self.encoder(emb, attention_mask)
        return seq, self.pooler(seq)


class BertPretrainingHeads(nn.Module):
    def __init__(self, c: BertConfig, embedding_weights=None, *,
                 device=None):
        super().__init__()
        kw = dict(device=device)
        self.transform = Linear(c.hidden_size, c.hidden_size, **kw)
        self.activation = GELU()
        self.layer_norm = LayerNorm(c.hidden_size, **kw)
        self.decoder = Linear(c.hidden_size, c.vocab_size, **kw)
        self.seq_relationship = Linear(c.hidden_size, 2, **kw)

    def forward(self, sequence_output, pooled_output):
        x = self.layer_norm(self.activation(self.transform(sequence_output)))
        return self.decoder(x), self.seq_relationship(pooled_output)


class BertForPretraining(nn.Module):
    """``BertModel`` with the MLM and NSP heads: the logits ``(prediction
    [B, L, V], seq_relationship [B, 2])``, or with ``masked_lm_labels``
    the fp32 loss."""

    def __init__(self, config: BertConfig = BERT_BASE, *, device=None):
        super().__init__()
        self.config = config
        self.bert = BertModel(config, device=device)
        self.device = self.bert.device
        self.cls = BertPretrainingHeads(config, device=self.device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_lm_labels=None, next_sentence_label=None):
        seq, pooled = self.bert(input_ids, token_type_ids,
                                attention_mask=attention_mask)
        pred, rel = self.cls(seq, pooled)
        if masked_lm_labels is None:
            return pred, rel
        loss = F.cross_entropy(
            pred.reshape(-1, self.config.vocab_size).float(),
            _on(masked_lm_labels, self.device).reshape(-1),
            ignore_index=-100)
        if next_sentence_label is not None:
            loss = loss + F.cross_entropy(
                rel.float(), _on(next_sentence_label, self.device)
                .reshape(-1))
        return loss


class BertForSequenceClassification(nn.Module):
    """The pooled output through dropout and a ``Linear`` classifier:
    logits ``[B, num_classes]``."""

    def __init__(self, config: BertConfig = BERT_BASE, num_classes=2,
                 dropout=None, *, device=None):
        super().__init__()
        self.bert = BertModel(config, device=device)
        self.device = self.bert.device
        self.dropout = Dropout(dropout if dropout is not None
                               else config.hidden_dropout_prob)
        self.classifier = Linear(config.hidden_size, num_classes,
                                 device=self.device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids,
                              attention_mask=attention_mask)
        return self.classifier(self.dropout(pooled))
