"""GPT-class training: optimizer, task, checkpoints, logging, the loop."""
