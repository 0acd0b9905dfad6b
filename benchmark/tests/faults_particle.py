"""The faults of the particle smoother a run of ``config5.particle.bulk``
must catch, planted underneath its program (``drivers/bulk_particle.py``'s
adapter, whose ``pipe`` is the ``Pipeline``): each wraps the adapter and
breaks the smoother alone."""

import dataclasses
import math

from faults import _Wrap


def _particles(state, **fields):
    """``state`` with the fields of its clouds replaced."""
    return dataclasses.replace(
        state, particles=state.particles._replace(**fields))


class CloudsUnchanged(_Wrap):
    """The clouds returned as the call found them (angles and weights);
    the key and every other field move on."""

    def blocks(self, state, x):
        ang, w = (t.clone() for t in state.particles[:2])
        state, outs = self.prog.blocks(state, x)
        return _particles(state, angles=ang, weights=w), outs


class KeyKept(_Wrap):
    """The key not advanced: every call draws the numbers of the first."""

    def blocks(self, state, x):
        key = state.particles.key.clone()
        state, outs = self.prog.blocks(state, x)
        return _particles(state, key=key), outs


class _Setting(_Wrap):
    """The smoother run with one of its settings changed underneath (the
    pipeline's plans read them at every step)."""

    def __init__(self, prog):
        super().__init__(prog)
        plans = prog.pipe.plans
        algo = plans.cfg.algo
        plans.cfg = dataclasses.replace(plans.cfg, algo=dataclasses.replace(
            algo, **self.changed(algo)))

    def blocks(self, state, x):
        return self.prog.blocks(state, x)


class NoResample(_Setting):
    """Resampling never taken: no ESS falls below a threshold of 0."""

    @staticmethod
    def changed(algo):
        return {"particle_resample_threshold": 0.0}


class StepHigh(_Setting):
    """The random walk's step 1 % larger than the configuration's."""

    @staticmethod
    def changed(algo):
        return {"particle_step_std_rad": algo.particle_step_std_rad * 1.01}


class DoaOff(_Wrap):
    """One block's DOA (the middle block's, first source) one grid step
    over, where it is produced (its audio as it was)."""

    def blocks(self, state, x):
        state, outs = self.prog.blocks(state, x)
        doa = outs["doa"].clone()
        g = self.prog.pipe.plans.cfg.algo.grid_points
        doa[doa.shape[0] // 2, 0] += 2.0 * math.pi / g
        return state, {**outs, "doa": doa}


def clouds_unchanged(prog):
    return CloudsUnchanged(prog)


def key_kept(prog):
    return KeyKept(prog)


def no_resample(prog):
    return NoResample(prog)


def step_high(prog):
    return StepHigh(prog)


def doa_off(prog):
    return DoaOff(prog)
