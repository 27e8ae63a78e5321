"""paddle's spelling ``nn.decode``: the seq2seq decoding API of
``nn/layer/decode.py``. Counterpart of ``paddle_tpu/nn/decode.py``."""
from .layer.decode import BeamSearchDecoder, Decoder, dynamic_decode

__all__ = ["BeamSearchDecoder", "Decoder", "dynamic_decode"]
