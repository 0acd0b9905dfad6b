"""The share of the traced window's device idle time (the gaps between
device operations) in which the host was inside ``mcax_torch.process_block``,
in %."""

from harness import spans


def read(run):
    st = spans.of_run(run, "process_block")
    if st is None or st.idle_us <= 0:
        return None
    return 100.0 * st.idle_in_us / st.idle_us
