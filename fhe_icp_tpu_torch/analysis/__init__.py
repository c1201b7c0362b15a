"""Analysis and benchmarking utilities.

* quantization — n_bits sweep: accuracy, circuit width and encrypted
  latency of the similarity model
* alternatives — FHE-friendly similarity metrics against exact cosine
* reduction — PCA / SVD / random-projection sweep with similarity
  preservation
* linear_math — a linear model on concatenated embeddings cannot learn
  cosine; on element-wise products it can
"""

from . import alternatives, linear_math, quantization, reduction  # noqa: F401
