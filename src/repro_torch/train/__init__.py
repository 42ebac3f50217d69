"""Training: the CTR trainer and its train step, the LM train steps
(``train_step``), the optimizers and checkpoints."""
