"""Does the fused trial's wrapper wait for the card?  (One CUDA card; not
collected by pytest.)

Queues a 20 ms ``torch.cuda._sleep`` on the stream, then times on the
host's clock one ``ops.trial.trial_eval`` call on ``chip_smoke.py``'s
flagship trial inputs (B=1024, f32): a wrapper that copies a table from
pageable host memory waits for the sleep to end (about 20 ms), one that
does not returns at once.  Also prints the call's time over 50
back-to-back calls (CUDA events).  Run it from the repository root with a
checkout's root as its argument, e.g. the parent unpacked by
``git archive`` into ``_scratch/parent``, one process per tree:

    python3 tests/trial_host_sync.py _scratch/parent
    python3 tests/trial_host_sync.py .
"""
import sys
import time


def main(tree):
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    from algames_tpu_torch.ops.trial import trial_eval
    dev = torch.device("cuda:0")
    prob, spec, gc, traj, dtraj, alpha, reg = cs.k2_inputs(dev,
                                                           torch.float32)
    args = (prob.model, spec, prob.obj, gc, traj, dtraj, alpha, reg)
    trial_eval(*args)
    torch.cuda.synchronize()
    cycles = int(20.0 / cs._sleep_ms_per_cycle())
    host = []
    for _ in range(11):
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        trial_eval(*args)
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    ms = cs.cuda_ms(lambda: trial_eval(*args), 50)
    print(f"{tree}: host time of a trial_eval call queued behind a 20 ms "
          f"device sleep, median of 11: {sorted(host)[5]:.3f} ms (about 20 "
          f"when the wrapper waits for the card); call {ms:.4f} ms (CUDA "
          f"events, 50 back-to-back calls, B=1024, f32)", flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
