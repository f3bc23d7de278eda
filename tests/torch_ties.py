"""The tie rules of the training tests (``test_torch_train.Decisions``),
apart from JAX so that ranks spawned by the distributed tests can use them.

A DAS or int8 decision that the port takes from the JAX package must lie
within ``TIE_RTOL`` of a tie of the port's own input, and at most
``MAX_FORCED`` of the decisions may be taken.
"""
import torch

TIE_RTOL = 1e-5            # a decision the port takes from JAX lies this near a tie
MAX_FORCED = 1e-4          # and at most this share of decisions is taken


def near_zero(x, block_size):
    """Per lane of x's blocks (N, block_size), whether |x| is within 1e-5
    of zero relative to its row's max |x|: relu(k)^2 of a k whose sign the
    two packages' float32 sums set apart (the rwkv channel-mix) is 1e-16 on
    one side and 0 on the other, which no relative gap can measure."""
    a = x.detach().abs().float()
    row = a.reshape(-1, a.shape[-1]).amax(-1, keepdim=True)
    main = a.shape[-1] - a.shape[-1] % block_size
    flat = a.reshape(-1, a.shape[-1])[:, :main]
    return (flat <= TIE_RTOL * row).reshape(-1, block_size)


def das_gaps(x, diff, block_size, keep):
    """Per block where the two masks differ, the gap between the keep-th
    and the next largest |x| relative to the keep-th, lanes near zero
    (``near_zero``) taken as 0: a block whose keep-th lane is one of them
    is at a tie with zero."""
    k = x.shape[-1]
    main = k - k % block_size
    assert not diff[..., main:].any(), "a dense tail lane differs"
    a = x.detach()[..., :main].abs().float().reshape(-1, block_size)
    a = torch.where(near_zero(x, block_size), 0.0, a)
    d = diff[..., :main].reshape(-1, block_size).any(-1)
    top = a[d].sort(-1, descending=True).values
    return (top[:, keep - 1] - top[:, keep]) / top[:, keep - 1].clamp_min(1e-30)


def int8_gaps(x, scale, diff):
    """Per differing value, how far |x / scale| lies from a .5 boundary,
    relative to |x / scale| (a relative error of x moves it by as much)."""
    r = (x.detach().float() / scale).abs()[diff]
    return ((r - r.floor()) - 0.5).abs() / r


def row_int8_gaps(x, scale, diff):
    """Per differing int8 value, how far x / scale lies from a .5
    boundary, relative to its row's absmax (127 scales)."""
    r = (x.detach().float() / scale).abs()[diff]
    return ((r - r.floor()) - 0.5).abs() / 127


def route_gaps(probs, own, want, diff):
    """Per token whose k experts differ (in set or order), how far apart the
    router probabilities of the two choices lie, relative to the own
    choice's: a k-th and (k+1)-th expert within this are at a tie."""
    rows = diff.any(-1)
    p_own = torch.gather(probs, -1, own)[rows].float()
    p_want = torch.gather(probs, -1, want.to(own.device))[rows].float()
    return ((p_own - p_want).abs() / p_own.clamp_min(1e-30)).amax(-1)


def fingerprint(x) -> tuple:
    """A key for a distinct input of a rounding decision: its shape and two
    float64 sums (a remat recompute gives the same bits, so the same key)."""
    d = x.detach().double()
    return tuple(x.shape), float(d.sum()), float(d.square().sum())


class Replay:
    """A run that takes another run's rounding decisions at near ties, on
    any device.  ``record`` keeps, in call order, each distinct input's DAS
    keep-mask (``ternary_linear.das_train_mask``), int8 values
    (``ternary.int8_quantize``), trits (``ternary.ternary_quantize``) and a
    MoE's routing (``moe.top_k_experts``: each token's k experts, a
    decision at a tie where the k-th and (k+1)-th probabilities lie within
    TIE_RTOL, ``route_gaps``) and an expert stack's per-expert scale
    (``ternary.stacked_scale``: a float32 mean whose summation order
    depends on how many experts the reduction holds, so a rank's scale of
    its experts may differ from one rank's by an ulp, and every trit at a
    .5 boundary with it; taken within TIE_RTOL, relative);
    ``force`` makes a later run take them.  Where a forced run's own
    decision differs, the difference must lie within TIE_RTOL of a tie of
    its own input (``worst``, by kind), at most MAX_FORCED of the decisions
    (``forced`` of ``total``; DAS lanes at a tie with zero count apart).
    The distance of a DAS keep-th lane or a trit from its tie is relative
    to the value (``das_gaps``, ``int8_gaps``); an int8 value's is relative
    to its row's absmax (``row_int8_gaps``): a sum-order error of an
    activation scales with the row it is summed into, not with the
    element, which may sit near zero.

    A rank's input is a cut of the recorded run's: its batch rows
    (``rows``, dim 0 of an activation) and, along any other dim whose size
    differs, its bounds (``bounds``: ``model_bounds``' cuts; ``index``: the
    rank's place on "model")."""

    KINDS = ("das", "int8", "trit", "route", "scale")

    def __init__(self, rows=slice(None), bounds=None, index=0):
        from repro_torch.core import ternary as tq
        from repro_torch.models import moe
        from repro_torch.models import ternary_linear as tl
        self.tq, self.tl, self.moe = tq, tl, moe
        self.rows, self.bounds, self.index = rows, bounds or {}, index
        self.orig = {"das": tl.das_train_mask, "int8": tq.int8_quantize,
                     "trit": tq.ternary_quantize, "route": moe.top_k_experts,
                     "scale": tq.stacked_scale}
        self.records, self.queue = None, {}
        self.forced = self.total = self.zero_ties = self.missing = self.left = 0
        self.worst = dict.fromkeys(self.KINDS, 0.0)

    def _patch(self, decide):
        """Route the three decisions through ``decide(kind, input, own,
        scale-or-tc) -> the decision taken``."""
        tq, tl, orig = self.tq, self.tl, self.orig

        def mask(x, tc):
            return decide("das", x, orig["das"](x, tc), tc)

        def quant(x, **kw):
            own = orig["int8"](x, **kw)
            return tq.QuantizedActivation(decide("int8", x, own.values, own.scale), own.scale)

        def trits(w, **kw):
            own = orig["trit"](w, **kw)
            return tq.TernaryWeight(decide("trit", w, own.values, own.scale), own.scale)

        def experts(probs, k):
            return decide("route", probs, orig["route"](probs, k), probs)

        def scale(w):
            return decide("scale", w, orig["scale"](w), None)

        tl.das_train_mask, tq.int8_quantize, tq.ternary_quantize = mask, quant, trits
        self.moe.top_k_experts, tq.stacked_scale = experts, scale

    def _close(self):
        self.left += sum(1 for q in self.queue.values() for _ in q)
        self.queue = {}

    def restore(self):
        """Put the three decisions back; count the records ``force`` was
        given that no call took."""
        self._close()
        self.tl.das_train_mask = self.orig["das"]
        self.tq.int8_quantize, self.tq.ternary_quantize = self.orig["int8"], self.orig["trit"]
        self.moe.top_k_experts, self.tq.stacked_scale = self.orig["route"], self.orig["scale"]

    def record(self):
        """Keep the decisions from now on; a new list of records a call
        (``records``: {kind: [host tensor, ...]})."""
        self.records, seen = {k: [] for k in self.KINDS}, set()

        def decide(kind, x, own, _):
            key = (kind,) + fingerprint(x)
            if key not in seen:
                seen.add(key)
                self.records[kind].append(own.detach().cpu())
            return own
        self._patch(decide)
        return self.records

    def _cut(self, full, like, kind=None):
        for d in range(full.ndim):
            big, k = full.shape[d], like.shape[d]
            if d == 0 and full.ndim >= 3 and kind != "scale":
                full = full[self.rows]
            elif big != k:
                lo, hi = next(c[self.index] for c in self.bounds.values()
                              if c[-1][1] == big and c[self.index][1] - c[self.index][0] == k)
                full = full.narrow(d, lo, hi - lo)
        return full.to(like.device).reshape(like.shape)

    def force(self, records):
        """Take ``records`` (``record``'s) in the calls from now on."""
        self._close()
        queue, seen = {k: iter(v) for k, v in records.items()}, {}
        self.queue = queue

        def decide(kind, x, own, arg):
            key = (kind,) + fingerprint(x)
            if key not in seen:
                want = next(queue[kind], None)
                if want is None:
                    self.missing += 1
                    return own
                seen[key] = self._cut(want, own, kind)
            want = seen[key]
            diff = own != want
            if diff.any():
                if kind == "das":
                    block, keep = arg.das.block, arg.das.keep
                    gaps = das_gaps(x, diff, block, keep)
                    main = x.shape[-1] - x.shape[-1] % block
                    zero = torch.zeros_like(diff)
                    zero[..., :main] = near_zero(x, block).reshape(zero[..., :main].shape)
                    self.zero_ties += int((diff & zero).sum())
                    diff = diff & ~zero
                elif kind == "int8":
                    gaps = row_int8_gaps(x, arg, diff)
                elif kind == "route":
                    gaps = route_gaps(arg, own, want, diff)
                elif kind == "scale":
                    gaps = ((own - want).abs() / want.abs())[diff].float()
                else:
                    gaps = int8_gaps(x, arg, diff)
                if gaps.numel():
                    self.worst[kind] = max(self.worst[kind], float(gaps.max()))
            self.forced += int(diff.sum())
            self.total += diff.numel()
            return want
        self._patch(decide)

    def ok(self) -> bool:
        """Every forced decision at a near tie, few of them, and the runs
        made the same distinct decisions (after ``restore``)."""
        return (max(self.worst.values()) <= TIE_RTOL
                and self.forced <= MAX_FORCED * max(self.total, 1)
                and self.missing == 0 and self.left == 0)

    def summary(self) -> str:
        return (f"{self.forced} of {self.total} decisions taken from one rank (and "
                f"{self.zero_ties} DAS lanes at a tie with zero), the farthest from a tie "
                f"{', '.join(f'{k} {v:.2e}' for k, v in self.worst.items())} (at most "
                f"{TIE_RTOL}); {self.missing} decisions not recorded, "
                f"{self.left} records left over")
