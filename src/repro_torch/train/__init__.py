"""Training: optimizer and the train step."""
