from atray.utils.profiling import Phase, phase_report, reset_phases, trace_to
