"""Running one scenario through both packages' ``execute`` for the port's
api tests: the port on the CPU, the reference as its own tests run it,
each trainer's runs recorded so the tests can print the step-size probes
each package saw, and the digital trajectory gate of the parity
contract (ROADMAP "Port rules")."""
import numpy as np
import pytest


def _spy(cls, record):
    real = cls.run

    def run(self, agg, **kw):
        log = real(self, agg, **kw)
        record.append(dict(scheme=log.scheme, eta=self.eta,
                           trials=kw["trials"], seed=kw["seed"],
                           acc=float(log.accuracy[:, -2:].mean())))
        return log

    return run


def execute_both(ref, spec_p, spec_r):
    """(port ResultSet, reference ResultSet, port runs, reference runs)
    of one spec, every cell computed (the reference's committed results
    under its own root are not read) and nothing saved."""
    from repro_torch.api import execute
    from repro_torch.fl.trainer import FLTrainer
    runs_p, runs_r = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FLTrainer, "run", _spy(FLTrainer, runs_p))
        mp.setattr(ref.trainer.FLTrainer, "run",
                   _spy(ref.trainer.FLTrainer, runs_r))
        rs_p = execute(spec_p, save=False, force=True, device="cpu")
        rs_r = ref.execute.execute(spec_r, save=False, force=True)
    return rs_p, rs_r, runs_p, runs_r


def probes(runs, scheme, seed):
    """[(eta, accuracy)] of one scheme's step-size probes (one trial on
    seed + 91, ``materialize.tune_and_run``)."""
    return [(r["eta"], r["acc"]) for r in runs
            if r["scheme"] == scheme and r["trials"] == 1
            and r["seed"] == seed + 91]


def check_probes(log_p, log_r, runs_p, runs_r, seed):
    """Print both packages' probe accuracies for one scheme and require
    the same chosen eta (ROADMAP Queue 3 records any flip)."""
    pp = probes(runs_p, log_p["scheme"], seed)
    pr = probes(runs_r, log_r["scheme"], seed)
    print(f"{log_p['scheme_key']}: probes port {pp} reference {pr}; "
          f"eta port {log_p['eta']} reference {log_r['eta']}")
    assert log_p["eta"] == log_r["eta"], (pp, pr)


def digital_gate(log_p, log_r, trials, n_samples):
    """The digital schemes' end-to-end gate: mean loss trajectories within
    4 combined standard errors of the trial means (the records' std is
    over trials, ddof 0), and the port's 1e-3 relative. Where every trial
    starts from the same model there is no spread; the floor there is the
    f32 rounding of the loss, a mean over ``n_samples`` that torch and XLA
    add in other orders: ceil(log2 n) ulps of it."""
    mp, mr = np.asarray(log_p["loss_mean"]), np.asarray(log_r["loss_mean"])
    sp, sr = np.asarray(log_p["loss_std"]), np.asarray(log_r["loss_std"])
    stderr = np.sqrt((sp ** 2 + sr ** 2) / (trials - 1))
    ulps = np.ceil(np.log2(n_samples))
    floor = ulps * np.spacing(np.float32(mr)).astype(np.float64)
    gap = np.abs(mp - mr)
    assert np.all(gap <= 4.0 * stderr + floor), (gap, stderr)
    np.testing.assert_allclose(mp, mr, rtol=1e-3, atol=0)
    assert np.all(np.isfinite(mp)) and mp[-1] < mp[0]
