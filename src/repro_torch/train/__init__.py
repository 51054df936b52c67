"""Training: AdamW with a global-norm clip, and the train step."""
