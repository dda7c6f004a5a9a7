"""Plain-torch stand-ins for the Hugging Face pieces the model-based text and multimodal
metrics need: a local snapshot reader (``snapshot``), the WordPiece and BPE tokenizers
(``wordpiece``, ``bpe``), the BERT/RoBERTa encoders (``encoders``), CLIP's two towers
(``clip``) and CLIP's image processor (``image_processor``).

The JAX package gets all of these from ``transformers``; the port needs none of
``transformers``, ``tokenizers``, ``safetensors``, ``msgpack``, ``regex`` or PIL, and
each piece reproduces what those libraries give for the same snapshot directory.
"""
