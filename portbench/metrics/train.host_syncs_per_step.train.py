"""Host syncs a step: the runtime calls in which the host waits for the
card (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``) made inside one of the train step's phase
regions, over the steps traced. Every blocking copy issues one, in either
direction: each ``.item()``, ``bool()`` or ``float()`` of a device tensor
and each upload of a host value counts once. 0.0 where the regions are
there and no call is."""
from portbench.harness import regions


def read(run):
    return regions.per_step(
        run, lambda t, ivs: sum(1 for o in t.launches.values()
                                if o.name in regions.SYNCS
                                and regions.within(ivs, o.start)))
