"""Training: the loss and step, AdamW, gradient compression."""
