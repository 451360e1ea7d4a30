"""Dataset and model-file readers."""
