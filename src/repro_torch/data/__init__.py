from .pipeline import Batcher, fcnn_classification_dataset  # noqa: F401
