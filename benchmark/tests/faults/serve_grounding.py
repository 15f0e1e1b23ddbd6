"""Faults of ``drivers/serve_grounding.py``."""


def alter_token(monkeypatch, cell):
    """A served answer altered where it is produced."""
    import vidsgg_big_tpu_torch.train.grounding_steps as steps
    real = steps.grounding_decode

    def altered(*a, **kw):
        spans, probs, kept = real(*a, **kw)
        return spans, probs * 0.99, kept
    monkeypatch.setattr(steps, "grounding_decode", altered)


FAULTS = [alter_token]
