"""Faults of ``drivers/serve_bigc.py``."""


def alter_token(monkeypatch, cell):
    """A served answer altered where it is produced."""
    import vidsgg_big_tpu_torch.train.steps as steps
    real = steps.construct_triplets

    def altered(*a, **kw):
        trip = real(*a, **kw)
        trip.quintuples[:, :, 0] = (trip.quintuples[:, :, 0] + 1) % 7
        return trip
    monkeypatch.setattr(steps, "construct_triplets", altered)


FAULTS = [alter_token]
