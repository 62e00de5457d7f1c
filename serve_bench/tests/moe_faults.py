"""Faults in a block_pattern model's sigmoid-routed experts
(``repro_torch.models.moe``), for the tests that check ``correct`` fails
under them. Each ``fault(prog, monkeypatch)`` patches the port's module
through ``monkeypatch`` (undone after the test); a step captured before it
(the dense batcher's padded prefills, captured when the program is built)
replays unbroken on the card, so there the decode steps carry the fault."""
import torch


def live_cleared(prog, mp):
    """The decode reads a live mask with no lane live: no token routes."""
    from repro_torch.models import moe as MOE
    inner = MOE.moe_apply_sigmoid

    def apply(params, cfg, x, *, live=None, **k):
        if live is not None and live.dim() == 1:
            live = torch.zeros_like(live)
        return inner(params, cfg, x, live=live, **k)
    mp.setattr(MOE, "moe_apply_sigmoid", apply)


def live_inverted(prog, mp):
    """The decode reads the live mask inverted: live lanes route nowhere,
    dead ones route."""
    from repro_torch.models import moe as MOE
    inner = MOE.moe_apply_sigmoid

    def apply(params, cfg, x, *, live=None, **k):
        if live is not None and live.dim() == 1:
            live = ~live
        return inner(params, cfg, x, live=live, **k)
    mp.setattr(MOE, "moe_apply_sigmoid", apply)


def slot_dropped(prog, mp):
    """Each token's last (k-th) choice weighs 0; the others keep their
    weights."""
    from repro_torch.models import moe as MOE
    inner = MOE.route_sigmoid

    def route(params, cfg, xt):
        idx, w = inner(params, cfg, xt)
        return idx, torch.cat([w[:, :-1], torch.zeros_like(w[:, -1:])], 1)
    mp.setattr(MOE, "route_sigmoid", route)


def gate_unnormalised(prog, mp):
    """The chosen scores times the routed scale, not normalised to sum 1
    first."""
    from repro_torch.models import moe as MOE
    inner = MOE.route_sigmoid

    def route(params, cfg, xt):
        idx, w = inner(params, cfg, xt)
        scores = torch.sigmoid(xt.float() @ params["router"]["w"].float())
        return idx, scores.gather(1, idx) * cfg.moe.routed_scale
    mp.setattr(MOE, "route_sigmoid", route)


MOE_FAULTS = {"live_cleared": live_cleared, "live_inverted": live_inverted,
              "slot_dropped": slot_dropped,
              "gate_unnormalised": gate_unnormalised}
