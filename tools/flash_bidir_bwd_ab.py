"""Time attention's backward kernel (csrc/flash_bidir_bwd.cu) in one
checkout, at the shapes chip_smoke.py holds it to.

The bf16 cases of chip_smoke.check_attn_backward and check_causal:
llada-8b's training attention (8, 128, 32 on 32, 128), qwen2-0.5b's
(8, 128, 14 on 2, 64), D 256 (4, 256, 10 on 1) with window 2048 and
kv_valid, llada-8b's heads at 1,024 positions (2, 1024, 32 on 32, 128),
causal (4, 96, 32 on 32, 128) and causal D 256 with window 64 and
kv_valid (2, 256, 10 on 1).  Each is three readings of the device time per
call (chip_smoke.kernel_ms: 20 calls in one CUDA graph).  Prints the card
and one JSON line with the readings and the registers of every
flash_bidir_bwd instantiation.

To compare two trees on one card, put the other one in a directory that
.gitignore lists and run both in one call, in the order a, b, b, a:

    python3 tools/flash_bidir_bwd_ab.py build/parent parent
    python3 tools/flash_bidir_bwd_ab.py . change
"""
import json
import sys
from pathlib import Path

# (what, B, S, Hq, Hkv, D, window, kv_valid lengths, causal)
CASES = (("llada-8b training", 8, 128, 32, 32, 128, None, None, False),
         ("qwen2-0.5b training", 8, 128, 14, 2, 64, None, None, False),
         ("D 256 window 2048 kv_valid", 4, 256, 10, 1, 256, 2048,
          (256, 128, 77, 1), False),
         ("llada-8b heads at 1,024 positions", 2, 1024, 32, 32, 128, None,
          None, False),
         ("causal llada-8b shape", 4, 96, 32, 32, 128, None, None, True),
         ("causal D 256 window 64 kv_valid", 2, 256, 10, 1, 256, 64,
          (256, 129), True))


def main(tree: str, label: str) -> int:
    root = Path(tree).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import torch
    import chip_smoke as cs
    from repro_torch import device
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_bidir as fb
    if not torch.cuda.is_available():
        print("flash_bidir_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    device.resolve("cuda")
    _build.build()
    print(f"[{label}] {cs.card_line()}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(1)
    out = {"label": label,
           "regs": {k: regs for lib, k, _, regs, _ in cs.kernel_attrs()
                    if lib == "flash_bidir_bwd"}}
    for what, B, S, Hq, Hkv, D, win, lens, causal in CASES:
        q, dout = (torch.randn(B, S, Hq, D, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(B, S, Hkv, D, generator=g, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        valid = None if lens is None else (
            torch.arange(S, device="cuda")[None, :]
            < torch.tensor(lens, device="cuda")[:, None])
        fn = lambda: fb.flash_bidir_bwd(  # noqa: E731
            q, k, v, dout, valid, win, 0, causal)
        out[what] = [cs.kernel_ms(fn, 20, what) for _ in range(3)]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
