"""Model families: text embedders, dimension reduction, encrypted
similarity scoring."""

from .embedder import BertEmbedder, HashingEmbedder, make_embedder
from .reduction import DimensionReducer
from .similarity import FHESimilarityModel

__all__ = ["BertEmbedder", "HashingEmbedder", "make_embedder",
           "DimensionReducer", "FHESimilarityModel"]
