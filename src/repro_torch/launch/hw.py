"""Target-hardware constants (NVIDIA H100 SXM) used by the roofline
analysis — the counterpart of ``repro.launch.hw``, which holds the TPU
v5e's.

These numbers parameterize the *model* of the machine the dry run plans
for; nothing here is measured. They are NVIDIA's data sheet for the SXM
part at its 700 W power limit, dense rates without sparsity: 989 TFLOP/s
in bf16, 80 GB of HBM at 3.35 TB/s, and NVLink at 450 GB/s each way a
card (900 GB/s both ways). A card set below 700 W runs slower under load;
:func:`device_properties` reads what a real card reports.

``NVLINK_BW`` stands where the reference has ``ICI_BW``: the one link rate
of the analytics' collective term, kept as the reference's
single-bandwidth formula. NVLink joins the 8 cards of one host only; a
16 x 16 mesh spans 32 hosts, so its ``model`` axis of 16 crosses hosts and
its traffic there runs on the inter-host network (InfiniBand, about 50 GB/s
a card), not on NVLink. The collective term is therefore a lower bound for
any axis longer than 8.
"""

PEAK_FLOPS_BF16 = 989e12     # per card, bf16 dense
HBM_BW = 3.35e12             # bytes/s per card
NVLINK_BW = 450e9            # bytes/s per card, each way
HBM_BYTES = 80e9             # 80 GB per card

# effective bytes moved per element of collective *output*, ring algorithms:
#   all-reduce = reduce-scatter + all-gather -> ~2x payload over the
#   slowest link; all-gather / reduce-scatter / all-to-all /
#   collective-permute -> ~1x
COLLECTIVE_MULTIPLIER = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def device_properties(device="cuda") -> dict:
    """What the card at ``device`` reports of itself
    (``torch.cuda.get_device_properties``): its name, SM count, memory in
    bytes and compute capability. Raises where there is no card; it never
    falls back to the constants above."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("device_properties needs a CUDA card; there is "
                           "none")
    props = torch.cuda.get_device_properties(torch.device(device))
    return {"name": props.name, "sm_count": props.multi_processor_count,
            "total_memory": props.total_memory,
            "capability": f"{props.major}.{props.minor}"}
