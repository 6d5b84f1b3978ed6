"""Preconditioner families, one file a family a configuration names
(`"preconditioner"` in its optimizer block), found by that name:

  program_kwargs(cfg, model)   PSGD's options for the family beyond the common ones
  coins(generator)             the caller-drawn coins of one step (None: none)
  span_targets()               [(module, attribute)] the step looks up at call
                               time for the preconditioner's spans
  step_flops(cfg, model)       minimal FLOPs a step: (update + apply, apply)
  bound_ms(cfg, model, calls, steps, mesh)
                               least time of the traced steps' calls, or None
  reference_kwargs(cfg, model) what `reference/<family>.py`'s `init` takes

The family's plain reference is `reference/<family>.py`.
"""
