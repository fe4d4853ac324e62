"""Member-steps that advanced a member not yet stopped, over the member-
steps computed (the batch width times the step iterations, counted by
K1_members' launches, ``ops/kernels.py`` ``launches``), over the whole
window."""


def read(ctx):
    c = ctx.counters
    if not c.get('computed_member_steps'):
        return None
    return 100.0 * c['useful_member_steps'] / c['computed_member_steps']
