"""ABR rate-control law on the device (mirror of dsv1_tpu/ops/rc.py).

Integer-exact form of the reference's per-frame ABR feedback
(quality2quant, dsv_encoder.c:70-168; statistics update,
dsv_encoder.c:816-848). With each picture's packed size computed on the
device (ops/piclen.py), the state never leaves the device; the encoder
reads only the chosen quality.

State layout (int32[8] tensor), mirroring DSV_ENCODER's rate-control
scalars (dsv_encoder.h:83-99):
  0 rc_quant   1 bpf_total   2 bpf_reset        3 bpf_avg
  4 total_P_frame_q  5 avg_P_frame_q  6 last_P_frame_over  7 back_into_range

Arithmetic: the JAX package computes in int32, so its products and sums
wrap, e.g. `(bpf_delta << 9)` at >4 MB/frame deviations, where the
reference's C ints would overflow too. Here every step runs in int64 and
wraps to int32 (`_wrap32`) wherever the int32 result could overflow.
"""

import torch

from ..constants import BPF_RESET, MAX_QUALITY, quality_percent

N_STATE = 8


def _wrap32(x):
    """int64 -> the int32 value of its low 32 bits, kept in int64."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def _clip(x, lo, hi):
    """jnp.clip: max with lo first, then min with hi (hi wins if lo > hi)."""
    return torch.minimum(torch.maximum(x, torch.as_tensor(lo, device=x.device)),
                         torch.as_tensor(hi, device=x.device))


def init_state(quality: int, device="cuda"):
    """dsv_enc_start rate-control init (dsv_encoder.c:724-734)."""
    q = max(0, min(int(quality), MAX_QUALITY))
    st = torch.zeros(N_STATE, dtype=torch.int32, device=device)
    st[0] = q
    st[5] = q * 4 // 5
    return st


def make_abr_law(cfg, meta):
    """Returns (quality_fn, stats_fn) closures over the static config.

    quality_fn(state, is_p, forced_intra) -> (quality 0-d int32, state')
    stats_fn(state, is_p, used_quality, pic_len) -> state'
    is_p and forced_intra are host bools (the encoder knows each frame's
    type); state, quality and pic_len are device tensors.
    """
    fps = (meta.fps_num << 5) // meta.fps_den or 1
    needed_bpf = ((cfg.bitrate << 5) // fps) >> 3
    step_cap = max(1, min(cfg.max_q_step, MAX_QUALITY))
    qp = quality_percent
    min_q, max_q = cfg.min_quality, cfg.max_quality
    min_iq = cfg.min_I_frame_quality
    nudge = bool(cfg.rc_high_motion_nudge)

    def quality_fn(st, is_p: bool, forced_intra: bool):
        s = st.to(torch.int64)
        q = s[0]
        bpf = torch.where(s[3] == 0, needed_bpf, s[3])
        dir_ = torch.where(bpf - needed_bpf > 0, -1, 1)
        delta = torch.div(_wrap32((bpf - needed_bpf).abs() << 9),
                          needed_bpf, rounding_mode="floor")
        delta = torch.where(dir_ == 1, _wrap32(delta * 2), delta)
        cap = step_cap
        if nudge:
            if is_p:
                n_over = s[6] != 0
                n_back = (s[6] == 0) & (s[7] != 0)
            else:
                n_over = torch.zeros_like(q, dtype=torch.bool)
                n_back = s[7] != 0
            nudged = n_over | n_back
            delta = torch.where(nudged, _wrap32((delta + 1) * 2), delta)
            dir_ = torch.where(n_over, -1, torch.where(n_back, 1, dir_))
            cap = torch.where(nudged, step_cap * 16, step_cap)
        delta = _wrap32(q * delta) >> 9
        delta = torch.minimum(delta, torch.as_tensor(cap, device=q.device))
        q = _wrap32(q + _wrap32(delta * dir_))
        minq = _clip(s[5] - qp(4), min_q, max_q) if is_p else min_iq
        if forced_intra:
            boost = torch.where(q < qp(60), qp(15),
                                torch.where(q < qp(70), qp(8),
                                            torch.where(q < qp(75), qp(3),
                                                        0)))
            q = _clip(q + boost, 0, max_q - qp(5))
        q = _clip(_clip(q, minq, max_q), 0, MAX_QUALITY).to(torch.int32)
        out = st.clone()
        out[0] = q
        return q, out

    def stats_fn(st, is_p: bool, used_quality, pic_len):
        s = st.to(torch.int64)
        pic_len = torch.as_tensor(pic_len, device=st.device).to(torch.int64)
        used = torch.as_tensor(used_quality, device=st.device) \
            .to(torch.int64)
        bpf_total = _wrap32(s[1] + pic_len)
        bpf_reset = s[2] + 1
        total_p = _wrap32(s[4] + used) if is_p else s[4]
        avg_p = (torch.div(total_p, bpf_reset, rounding_mode="floor")
                 if is_p else s[5])
        went_under = pic_len < (needed_bpf * 3 // 4)
        went_over = pic_len > (needed_bpf * 7 // 8)
        zero = torch.zeros_like(went_over)
        back = ((s[6] != 0) & went_under) if is_p else zero
        last_over = went_over if is_p else zero
        bpf_avg = torch.div(bpf_total, bpf_reset, rounding_mode="floor")
        do_reset = bpf_reset >= BPF_RESET
        bpf_total = torch.where(do_reset, bpf_avg, bpf_total)
        total_p = torch.where(do_reset, torch.div(total_p, bpf_reset,
                                                  rounding_mode="floor"),
                              total_p)
        bpf_reset = torch.where(do_reset, 1, bpf_reset)
        return torch.stack([s[0], bpf_total, bpf_reset, bpf_avg, total_p,
                            avg_p, last_over.to(torch.int64),
                            back.to(torch.int64)]).to(torch.int32)

    return quality_fn, stats_fn
