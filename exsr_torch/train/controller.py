"""Host-side GAN training controller of the SR trainer.

The port's own copy of ``exsr/train/controller.py`` (numpy only): a state
machine over the logged scalars that decides, per outer iteration,

* whether D steps and/or G steps run (the update ratio and the D
  verification),
* whether training is unstable and rolls back to an earlier checkpoint
  with a halved learning rate (the D-loss-STD trigger, and the symmetric
  critic-collapse guard),
* when to give up (learning rate below 1e-8).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GDUpdateController:
    """Adaptive G/D step-interval controller (utils/util.py:113-168).

    ``intervals_values`` is either a scalar ratio (positive: D:G steps per
    G step; negative: G steps per D step) or a pair of (interval-range,
    value-range) lists mapping a monitored value linearly onto an interval.
    """
    intervals_values: object = 0
    dg_steps_ratio: float = 0.0
    steps_since_d: int = 0
    steps_since_g: int = 0
    force_d: bool = False
    last_g_interval: int = 0
    last_d_interval: int = 0

    def __post_init__(self):
        if not isinstance(self.intervals_values, (list, tuple)):
            self.dg_steps_ratio = float(self.intervals_values)

    def _interval(self, value: float) -> float:
        iv = self.intervals_values
        if not isinstance(iv, (list, tuple)):
            return float(iv)
        a = (iv[0][1] - iv[0][0]) / (iv[1][1] - iv[1][0])
        return float(np.clip(a * (value - iv[1][1]) + iv[0][1],
                             min(iv[0]), max(iv[0])))

    def step_query(self, g_not_d: bool) -> bool:
        if g_not_d:
            self.steps_since_g += 1
            return self.steps_since_g >= self.dg_steps_ratio
        self.steps_since_d += 1
        return self.steps_since_d >= -self.dg_steps_ratio or self.force_d

    def step_performed(self, g_not_d: bool) -> None:
        if g_not_d:
            self.last_g_interval = self.steps_since_g
            self.steps_since_g = 0
        else:
            self.force_d = False
            self.last_d_interval = self.steps_since_d
            self.steps_since_d = 0

    def update_ratio(self, value: float) -> None:
        self.dg_steps_ratio = self._interval(value)

    def query_update_ratio(self) -> float:
        if self.last_d_interval > self.last_g_interval:
            return -self.last_d_interval
        return self.last_g_interval


@dataclasses.dataclass
class GANController:
    """Per-step gating + instability detection (SRRaGAN_model semantics)."""
    d_update_ratio: object = 10
    d_valid_steps_4_g: int = 10
    min_d_prob_ratio_4_g: float = 1.05
    min_mean_d_correct: float = 0.9
    d_init_iters: int = 0
    d_verification: str | None = 'past'
    steps_4_loss_std: int = 500
    std_4_lr_drop: float | None = 1e6
    lr_gamma: float = 0.5
    base_lr: float = 1e-5       # abort when base_lr * lr_scale < 1e-8

    steps_4_d_convergence: int = 2000
    lr_change_ratio: float = 4.0

    step: int = 0
    generator_started_learning: bool = False
    verified_d_saved: bool = False
    d_verified: bool = False
    d_converged: bool = False
    lr_scale: float = 1.0
    log: dict = dataclasses.field(default_factory=dict)
    gd_controller: GDUpdateController | None = None

    def __post_init__(self):
        for k in ('D_logits_diff', 'Correctly_distinguished', 'l_d_real',
                  'l_d_fake', 'D_loss_STD'):
            self.log.setdefault(k, [])
        if isinstance(self.d_update_ratio, (list, tuple)):
            self.gd_controller = GDUpdateController(self.d_update_ratio)

    # --------------------------------------------------------------- gating
    def _past_window_ok(self, n: int) -> bool:
        diffs = self.log['D_logits_diff'][-n:]
        correct = self.log['Correctly_distinguished'][-n:]
        if len(diffs) < n:
            return False
        thresh = np.log(self.min_d_prob_ratio_4_g)
        return (all(v > thresh for v in diffs)
                and all(v > self.min_mean_d_correct for v in correct))

    def want_g_step(self) -> bool:
        """SRRaGAN_model.py:287-295 + the D-verification gates:
        'past' (:379-382), 'current' (:394-396), 'convergence' (:383-393),
        'initial'/'initial_gradual' (DecompCNN_model.py:536-567)."""
        if self.step <= self.d_init_iters:
            return False
        if self.gd_controller is not None:
            ok = self.gd_controller.step_query(True)
        else:
            ratio = max(1, int(self.d_update_ratio))
            ok = self.step % ratio == 0
        if not ok:
            return False
        mode = self.d_verification
        n = self.d_valid_steps_4_g
        if mode == 'past' and n > 0:
            return self._past_window_ok(n)
        if mode in ('initial', 'initial_gradual') and n > 0:
            # once verified, stay verified ('initial'); gradual mode
            # re-verifies over a 100x window (DecompCNN_model.py:555-567)
            if self.d_verified:
                return True
            if self._past_window_ok(n):
                if mode == 'initial':
                    self.d_verified = True
                else:
                    win = 100 * n
                    diffs = self.log['D_logits_diff'][-win:]
                    correct = self.log['Correctly_distinguished'][-win:]
                    if len(diffs) >= win and \
                            np.mean(diffs) > np.log(
                                self.min_d_prob_ratio_4_g) and \
                            np.mean(correct) > self.min_mean_d_correct:
                        self.d_verified = True
                return True
            if self.gd_controller is not None:
                self.gd_controller.force_d = True
            return False
        if mode == 'current':
            if not self.log['D_logits_diff']:
                return False
            return self.log['D_logits_diff'][-1] > np.log(
                self.min_d_prob_ratio_4_g)
        if mode == 'convergence':
            # D considered converged when its loss trend flattens relative
            # to its noise (SRRaGAN_model.py:383-393)
            if not self.d_converged and \
                    self.step >= self.steps_4_d_convergence:
                std = slope = 0.0
                for key in ('l_d_real', 'l_d_fake'):
                    vals = self.log[key][-self.steps_4_loss_std:]
                    if len(vals) < 3:
                        return False
                    x = np.arange(len(vals))
                    (cur_slope, _), cov = np.polyfit(x, vals, 1, cov=True)
                    std += 0.5 * float(np.sqrt(cov[0][0]))
                    slope += 0.5 * float(cur_slope)
                self.d_converged = \
                    -self.lr_change_ratio * min(-1e-5, slope) < std
            return self.d_converged
        return True

    def want_d_step(self) -> bool:
        """SRRaGAN_model.py:296-305."""
        if self.step < -self.d_init_iters:
            return False
        if self.gd_controller is not None:
            return self.gd_controller.step_query(False)
        if not self.verified_d_saved:
            return True
        ratio = max(1, int(np.ceil(1 / max(self.d_update_ratio, 1e-9))))
        return self.step % ratio == 0

    # -------------------------------------------------------------- logging
    def record_d(self, metrics: dict) -> None:
        self.log['D_logits_diff'].append(float(metrics['D_logits_diff']))
        self.log['Correctly_distinguished'].append(
            float(metrics['Correctly_distinguished']))
        self.log['l_d_real'].append(float(metrics.get(
            'l_d_real_0', metrics.get('l_d_real', 0.0))))
        self.log['l_d_fake'].append(float(metrics.get(
            'l_d_fake_0', metrics.get('l_d_fake', 0.0))))
        if self.gd_controller is not None:
            self.gd_controller.step_performed(False)

    def record_g(self) -> None:
        self.generator_started_learning = True
        self.verified_d_saved = True
        if self.gd_controller is not None:
            self.gd_controller.step_performed(True)

    def tick(self) -> None:
        self.step += 1

    # ---------------------------------------------------- stability rollback
    def check_critic_collapse(self, diff_max: float = 0.02,
                              mag_min: float = 0.5,
                              window: int = 200,
                              inflation_min: float = 1.25,
                              mag_hi: float = 1.0) -> bool:
        """Detect the symmetric critic collapse that the D-loss-STD
        trigger cannot see (``exsr``'s extension,
        ``exsr/train/controller.py:209-257``, where its calibration is
        written up): over the last ``window`` D records the median
        ``|D_logits_diff|`` is below ``diff_max`` (no separation), the
        median magnitude ``(|l_d_real| + |l_d_fake|) / 2`` exceeds
        ``mag_min``, and either the window's second half has a median at
        least ``inflation_min`` times its first half's (inflating) or the
        median exceeds ``mag_hi`` (the plateau after a runaway).  The
        real/fake mean that :meth:`check_lr_drop` watches cancels exactly
        in this mode.  Callers route a True through the same rollback as
        :meth:`check_lr_drop`."""
        n = window
        diffs = self.log['D_logits_diff'][-n:]
        if len(diffs) < n:
            return False
        mags = [(abs(r) + abs(f)) / 2
                for r, f in zip(self.log['l_d_real'][-n:],
                                self.log['l_d_fake'][-n:])]
        m_old = float(np.median(mags[:n // 2]))
        m_new = float(np.median(mags[n // 2:]))
        m_med = float(np.median(mags))
        return (float(np.median(np.abs(diffs))) < diff_max
                and m_med > mag_min
                and (m_new > inflation_min * max(m_old, 1e-12)
                     or m_med > mag_hi))

    def halve_lr(self) -> bool:
        """Apply one instability LR halving; returns lr_too_low — the
        abort condition every rollback trigger must share (the reference's
        LR < 1e-8 stop, SRRaGAN_model.py:618-631).  Used by both the
        D-loss-STD path (check_lr_drop) and the critic-collapse guard so
        repeated rollbacks from either trigger hit the same stop."""
        self.lr_scale *= self.lr_gamma
        return self.lr_scale * self.base_lr < 1e-8

    def check_lr_drop(self) -> tuple[bool, bool]:
        """(should_rollback, lr_too_low) — LOSS_BASED branch of
        update_learning_rate (SRRaGAN_model.py:592-632): rollback when the
        recent D-loss STD exceeds the threshold; abort when LR < 1e-8."""
        n = self.steps_4_loss_std
        if len(self.log['D_logits_diff']) < 2 * n:
            return False, False
        vals = [(r + f) / 2 for r, f in zip(self.log['l_d_real'][-n:],
                                            self.log['l_d_fake'][-n:])]
        std = float(np.std(vals))
        self.log['D_loss_STD'].append((self.step, std))
        if self.std_4_lr_drop is None or std <= self.std_4_lr_drop:
            return False, False
        return True, self.halve_lr()
