"""Config, task knobs, sample function and the trainer."""
