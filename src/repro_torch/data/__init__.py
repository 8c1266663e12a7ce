from .pipeline import Batcher, fcnn_classification_dataset, token_stream  # noqa: F401
