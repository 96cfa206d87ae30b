"""Training: optimizers (AdamW, Adafactor), the train-step builder
(autograd gradients, microbatch accumulation, remat through the model's
``cfg.remat``), checkpointing with async writes and restart, and the
synthetic data pipeline."""
