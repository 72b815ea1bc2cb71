"""Training: the criterion, the AdamW step and the Trainer."""
